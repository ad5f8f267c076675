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
// Forward bound: at the LM's serving shape ([8, 8, 100, 64] bf16) the whole
// problem is a few hundred KB (1.0 us of bytes at 3.35 TB/s), at the
// pre-net's time rows ([640, 1, 134, 64]) 44 MB (13.1 us): bytes, never the
// tensor cores, bound it, and the small shapes are bound by latency. Two
// paths, by type and shape alone (fwd_path, kernels/attention.py fwd_path):
//   bf16 at Tk <= 160 and Dh <= 64, any Tq (every forward of the LM and e2e
//   paths: the LM's [8, 8, 100, 64] causal and [64, 8, 64, 64] causal keep
//   0.5, the encoder's [8, 8, 134, 64] (keep 0.9 in training), the time
//   rows, the decoder's causal [8, 8, 65, 64] and cross q 65 / kv 134, keep
//   0.9): masked_attention_mma_kernel. A block takes one (b, h) and up to
//   64 query rows (Tq's 16-row tiles spread evenly over the fewest blocks of
//   at most four warps) and stages K and V once with cp.async into padded
//   rows (mma.cuh), with each key's additive mask in f32 beside them. A warp
//   takes 16 query rows: Q's A fragments straight from global memory, S =
//   Q.K^T on mma.sync m16n8k16 with f32 accumulation, the whole score row
//   in registers (20 n8 tiles at Tk 160), so that one pass gives the exact
//   softmax of the normalised, rounded P (no online rescaling): the score
//   rounded, the mask added (-1e9 never a skip: a row whose keys are all
//   invalid spreads over all Tk keys, future ones included; key padding is
//   -inf, out of the max, the sum and P.V), quad shuffles for the row max
//   and sum, expf, the division by the sum (a reciprocal and one FMA
//   correction: the correctly rounded quotient, without the slow path `/`
//   takes for the zero numerators of masked keys), P rounded to bf16; with
//   a keep mask (its bits loaded before the products, 16 bits at a time
//   where Tk is even) (P / keep) rounded, times the mask. P goes from the
//   accumulator layout straight into A fragments, O = P.V through
//   ldmatrix.trans of V, one bf16 store: no atomics, the same output from
//   launch to launch. Instances by 16-key tiles (4, 7, 10), keep mask and
//   causal. Shared memory (mma_fwd_smem, kernels/attention.py
//   mma_fwd_smem_bytes): 16 + 4 Tk stride(Dh) + 64 tiles16(Tk) bytes at
//   Dh 64: 18,704 at Tk 64, 19,056 at Tk 65, 29,264 at Tk 100, 39,184 at
//   Tk 134, at most 46,736 (Tk 160), within the 48 KB a block gets without
//   opting in.
//   Elsewhere (f32, Tk above 160, Dh above 64): masked_attention_kernel,
//   one block per (b*h, 16-query tile), one warp per query row at a time:
//   lanes own keys for the scores and the softmax (warp shuffles for max
//   and sum), then own head dims for P.V. The keys are walked in chunks of
//   64 staged in shared memory (K rows padded by one 32-bit word so lanes
//   reading different keys hit different banks), in three walks: the row
//   max, the sum, then P and P.V. Up to Tk 512 the first walk keeps the
//   block's scores in shared memory for the other two; above it each walk
//   recomputes them, so that shared memory (smem_bytes, kernels/attention.py
//   fwd_smem_bytes) stops growing with Tk: 38,144 bytes at f32 Dh 64 and
//   75,008 at f32 Dh 128 with no scores kept, at most 107,776 with them,
//   and the kernel takes every Tk at Dh <= 128. Past Tk 512 the kept scores
//   cost more in blocks per SM than recomputing them costs in arithmetic
//   (timed both ways on an NVIDIA H100 80GB HBM3 at 700.00 W). Each key stays with lane j
//   mod 32 and P.V sums keys in order, so it gives, bit for bit, the
//   outputs of the earlier kernel that staged a (b, h)'s whole K and V (and
//   refused Tk above 435 at f32 Dh 64), scores kept or not; no online
//   softmax, which would round P otherwise. The
//   TPU version's block-diagonal row packing was an MXU-shape device and
//   is dropped.
//
// Backward (recompute VJP, as _mflash_bwd_kernel): P = exp(s - max) / sum
// in f32 (not the forward's softmax call); dP = dO.V^T; with dropout
// dP *= mask / keep_prob and dropped = (P_type / keep) * mask, else
// dropped = P_type; dsum = sum(dP * P) over the undropped f32 P;
// dS = P * (dP - dsum) * scale rounded to the input type; dQ = dS.K,
// dK = dS^T.Q, dV = dropped^T.dO, all accumulated in f32.
// Bound: at the LM's training shape ([64, 8, 64, 64] bf16, keep 0.5) the
// function moves 31.5 MB (Q, K, V, dO, the keep mask and the three
// gradients: 9.4 us at 3.35 TB/s) for 10 products over the causal
// triangle (0.7 us of bf16 tensor-core time): it is bound by bytes, and
// each (b, h) is a few tens of KB, so the kernel must not recompute or
// re-stage what one block can hold.
//   bf16 at Tq, Tk <= 160 and Dh <= 64 (bwd_path 1; every shape of the LM
//   and e2e training paths: the LM's [64, 8, 64, 64] causal, the e2e
//   encoder's [8, 8, 134, 64], the pre-net's time rows [640, 1, 134, 64],
//   the decoder's causal [8, 8, 65, 64] and cross q 65 / kv 134):
//   masked_attention_bwd_mma_kernel, one block per (b, h), modelled on
//   dual_attention_bwd_mma_kernel. Q, K, V and dO are staged once with
//   cp.async into padded rows (mma.cuh); a warp takes 16 query rows: S =
//   Q.K^T on mma.sync m16n8k16 with f32 accumulation, the scale and the
//   additive mask (key-valid row, causal; never a skip, so a row whose
//   keys are all invalid spreads over all Tk keys, future ones included),
//   the softmax in registers with each score formed once; dP = dO.V^T on
//   the tensor cores key tile by key tile, twice (dsum over the unrounded
//   P, then dS); the key-valid row and the keep mask read from global
//   memory (staging them in shared memory was slower: byte copies, and
//   fewer blocks an SM); the dropped P and dS in bf16 through shared
//   memory; dQ = dS.K from dS in registers. After one barrier a warp takes
//   16 key rows: dK = dS^T.Q and dV = dropped^T.dO by
//   ldmatrix.trans. Shared memory (mma_bwd_smem, kernels/attention.py
//   mma_bwd_smem_bytes): 16 + (2 Tq + 2 Tk) (Dh + 8) 2 + 2 Tq stride(Tk) 2
//   bytes: 55,312 at [64, 64, 64] (four blocks an SM), 150,096 at [134,
//   134, 64] (the encoder and the time rows), 56,176 at the decoder's [65,
//   65, 64], 92,688 at q 65 / kv 134; at most 199,696 (Tq = Tk = 160).
//   Each output is written once, no atomics: the same output from launch
//   to launch.
//   Elsewhere (f32, Dh above 64, T above 160): FlashAttention-2's recompute
//   in two launches, so that a block's shared memory depends on Dh alone
//   and the backward takes every (Tq, Tk) the forward takes. Launch
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
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 16;
constexpr int kFwdRowsPerWarp = kRowsPerBlock / kWarps;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90
constexpr float kBigNeg = -1e9f;
constexpr int kMaxDh = 128;
constexpr int kDSlots = kMaxDh / 32;    // head dims a lane owns
constexpr int kKeyChunk = 64;           // keys staged at a time
constexpr int kMaxKeptTk = 512;         // scalar forward keeps scores to here

// K row stride in elements: Dh plus one 32-bit word of padding.
template <typename T>
__host__ __device__ constexpr int k_stride(int dh) {
  return dh + static_cast<int>(4 / sizeof(T));
}

// Reserves `bytes` at `off` (kept 16-byte aligned) and returns its offset.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = (off + bytes + 15) / 16 * 16;
  return at;
}

// The scalar forward's shared memory, in this order: a K chunk
// [64][k_stride] and a V chunk [64][Dh] in T; the block's 16 query rows in
// f32 [16][Dh]; per warp a P chunk [64] f32; and, where Tk <= kMaxKeptTk,
// the block's scores [16][Tk] f32 (`kept`). Independent of Tq; at most
// 75,008 + 32,768 bytes (f32, Dh 128, Tk 512).
template <typename T>
struct FwdLayout {
  size_t k, v, rows, p, s, total;
  bool kept;
  __host__ __device__ FwdLayout(int dh, int tk) {
    size_t off = 0;
    k = take(off, static_cast<size_t>(kKeyChunk) * k_stride<T>(dh) *
                      sizeof(T));
    v = take(off, static_cast<size_t>(kKeyChunk) * dh * sizeof(T));
    rows = take(off, static_cast<size_t>(kRowsPerBlock) * dh * sizeof(float));
    p = take(off, static_cast<size_t>(kWarps) * kKeyChunk * sizeof(float));
    kept = tk <= kMaxKeptTk;
    s = take(off, kept ? static_cast<size_t>(kRowsPerBlock) * tk *
                             sizeof(float)
                       : 0);
    total = off;
  }
};

template <typename T>
size_t smem_bytes(int dh, int tk) {
  return FwdLayout<T>(dh, tk).total;
}

// The score of one (query, key) pair, as every scalar kernel here forms
// it: an f32 dot product over d in order, times scale (rounded: no
// contraction), plus the mask.
template <typename Q, typename K>
__device__ __forceinline__ float score(const Q* qr, const K* kr, int Dh,
                                       float scale, bool ok) {
  float acc = 0.f;
  for (int d = 0; d < Dh; ++d) acc = fmaf(to_f32(qr[d]), to_f32(kr[d]), acc);
  return __fadd_rn(__fmul_rn(acc, scale), ok ? 0.f : kBigNeg);
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

// One block per (b*h, 16 query rows), one warp per query row at a time
// (warp w takes rows w, w + 4, ...; four a warp, all in flight at once).
// Three walks over the keys: (0) the row max, (1) the sum of
// expf(s - max), (2) P = expf(s - max) / sum rounded to T (then the keep
// mask), into a per-warp chunk, and P.V. Walks over K or V stage chunks of
// 64 keys in shared memory. Where the block's scores fit (`kept`, Tk <=
// kMaxKeptTk) walk 0 stores them, walk 1 reads them without staging and
// walk 2 stages V alone; above that every walk stages K and recomputes
// each score. Key j stays with lane j mod 32 for the max and the sum, P.V
// is summed over j = 0..Tk-1 in order, and the reductions are the same xor
// shuffles: the arithmetic, and so every output bit, of the earlier kernel
// that staged a (b, h)'s whole K and V, on either side of kMaxKeptTk.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
masked_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ k_valid,
                        const unsigned char* __restrict__ keep,
                        float keep_prob, T* __restrict__ out, int H, int Tq,
                        int Tk, int Dh, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout<T> lay(Dh, Tk);
  const bool kept = lay.kept;
  const int ks_stride = k_stride<T>(Dh);
  T* kc = reinterpret_cast<T*>(smem + lay.k);
  T* vc = reinterpret_cast<T*>(smem + lay.v);
  float* qrows = reinterpret_cast<float*>(smem + lay.rows);
  float* srows = reinterpret_cast<float*>(smem + lay.s);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* pc = reinterpret_cast<float*>(smem + lay.p) + warp * kKeyChunk;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int row0 = static_cast<int>(blockIdx.y) * kRowsPerBlock;
  const size_t q_off = static_cast<size_t>(bh) * Tq * Dh;
  const size_t kv_off = static_cast<size_t>(bh) * Tk * Dh;
  for (int i = threadIdx.x; i < kRowsPerBlock * Dh; i += blockDim.x) {
    const int row = row0 + i / Dh;
    qrows[i] = row < Tq ? to_f32(q[q_off + static_cast<size_t>(row0) * Dh +
                                   i])
                        : 0.f;
  }  // read after the first chunk's barrier

  const unsigned char* valid_row = k_valid + static_cast<size_t>(b) * Tk;
  const float kp = to_f32(from_f32<T>(keep_prob));
  float m[kFwdRowsPerWarp], sum[kFwdRowsPerWarp];
  float acc[kFwdRowsPerWarp][kDSlots];
#pragma unroll
  for (int r = 0; r < kFwdRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    sum[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDSlots; ++t) acc[r][t] = 0.f;
  }

  for (int pass = 0; pass < 3; ++pass) {
    if (kept && pass == 1) {
      // the sum from the kept scores, keys in the same lane order
#pragma unroll
      for (int r = 0; r < kFwdRowsPerWarp; ++r) {
        const int rr = warp + r * kWarps;
        if (row0 + rr >= Tq) break;  // warp-uniform
        const float* sr = srows + static_cast<size_t>(rr) * Tk;
        for (int key = lane; key < Tk; key += 32)
          sum[r] += expf(sr[key] - m[r]);
        sum[r] = warp_sum(sum[r]);
      }
      continue;
    }
    const bool stage_k = pass == 0 || !kept;
    for (int c0 = 0; c0 < Tk; c0 += kKeyChunk) {
      const int n = min(kKeyChunk, Tk - c0);
      __syncthreads();  // the previous chunk is read by every warp
      for (int i = threadIdx.x; i < n * Dh; i += blockDim.x) {
        const int r = i / Dh;
        const int c = i - r * Dh;
        const size_t g = kv_off + static_cast<size_t>(c0) * Dh + i;
        if (stage_k) kc[r * ks_stride + c] = k[g];
        if (pass == 2) vc[i] = v[g];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kFwdRowsPerWarp; ++r) {
        const int rr = warp + r * kWarps;
        const int row = row0 + rr;
        if (row >= Tq) break;  // warp-uniform
        const float* qs = qrows + rr * Dh;
        float* sr = srows + static_cast<size_t>(rr) * Tk;
        if (pass < 2) {
          for (int j = lane; j < n; j += 32) {
            const int key = c0 + j;
            const bool ok = valid_row[key] != 0 && (!causal || key <= row);
            const float s = score(qs, kc + j * ks_stride, Dh, scale, ok);
            if (pass == 0) {
              m[r] = fmaxf(m[r], s);
              if (kept) sr[key] = s;  // read back by this lane alone
            } else {
              sum[r] += expf(s - m[r]);
            }
          }
          continue;
        }
        // probabilities rounded to the input type before P.V
        const unsigned char* keep_row =
            keep == nullptr
                ? nullptr
                : keep + (static_cast<size_t>(bh) * Tq + row) * Tk;
        for (int j = lane; j < n; j += 32) {
          const int key = c0 + j;
          float s;
          if (kept) {
            s = sr[key];
          } else {
            const bool ok = valid_row[key] != 0 && (!causal || key <= row);
            s = score(qs, kc + j * ks_stride, Dh, scale, ok);
          }
          float p = to_f32(from_f32<T>(expf(s - m[r]) / sum[r]));
          // dropout: (p / keep_prob) * mask in the input type
          if (keep_row != nullptr)
            p = keep_row[key] ? to_f32(from_f32<T>(p / kp)) : 0.f;
          pc[j] = p;
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < kDSlots; ++t) {
          const int d = lane + 32 * t;
          if (d < Dh) {
            for (int j = 0; j < n; ++j)
              acc[r][t] = fmaf(pc[j], to_f32(vc[j * Dh + d]), acc[r][t]);
          }
        }
        __syncwarp();  // pc is rewritten by the next row
      }
    }
#pragma unroll
    for (int r = 0; r < kFwdRowsPerWarp; ++r) {
      if (pass == 0) m[r] = warp_max(m[r]);
      if (pass == 1) sum[r] = warp_sum(sum[r]);  // recomputed walk only
    }
  }
#pragma unroll
  for (int r = 0; r < kFwdRowsPerWarp; ++r) {
    const int row = row0 + warp + r * kWarps;
    if (row >= Tq) break;
#pragma unroll
    for (int t = 0; t < kDSlots; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh)
        out[q_off + static_cast<size_t>(row) * Dh + d] = from_f32<T>(acc[r][t]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_valid,
           const void* keep, float keep_prob, void* out, int B, int H, int Tq,
           int Tk, int Dh, float scale, int causal, cudaStream_t stream) {
  if (Dh < 1 || Dh > kMaxDh || Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(Dh, Tk);
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
constexpr int kRowsPerWarp = 2;         // launch (a): query rows of a warp
constexpr int kBwdQRows = kBwdWarps * kRowsPerWarp;
constexpr int kKeysPerWarp = 2;         // launch (b): key rows of a warp
constexpr int kBwdKRows = kBwdWarps * kKeysPerWarp;
constexpr int kQueryChunk = 32;         // launch (b): queries staged, one a lane

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

template <typename A, typename B>
__device__ __forceinline__ float dot(const A* a, const B* b, int Dh) {
  float acc = 0.f;
  for (int d = 0; d < Dh; ++d) acc = fmaf(to_f32(a[d]), to_f32(b[d]), acc);
  return acc;
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

// ------------------------------------------- bf16 backward, tensor cores

constexpr int kMmaMaxT = 160;   // Tq and Tk the one-block kernel takes
constexpr int kMmaMaxDh = 64;   // Dh it takes (four 16-column tiles)

// One 16-byte block of zeros, then Q and dO [Tq][row_stride(Dh)], K and V
// [Tk][row_stride(Dh)], and the dropped-P and dS tiles [Tq][row_stride(Tk)],
// all bf16.
__host__ __device__ constexpr size_t mma_bwd_smem(int tq, int tk, int dh) {
  return 16 + (2 * static_cast<size_t>(tq) * row_stride(dh, true) +
               2 * static_cast<size_t>(tk) * row_stride(dh, true) +
               2 * static_cast<size_t>(tq) * row_stride(tk, true)) *
                  2;
}
// the layout grows with Tq, Tk and Dh, so it fits at every shape within
// the limits (199,696 bytes at the largest)
static_assert(mma_bwd_smem(kMmaMaxT, kMmaMaxT, kMmaMaxDh) <=
                  static_cast<size_t>(kMaxSmem),
              "the tensor-core backward's limits exceed shared memory");

// 1 where the backward takes the one-block tensor-core kernel, 0 where the
// two chunked launches: by shape and type alone.
inline int bwd_path(int dtype_code, int tq, int tk, int dh) {
  return dtype_code == 1 && tq <= kMmaMaxT && tk <= kMmaMaxT &&
                 dh <= kMmaMaxDh
             ? 1
             : 0;
}

// The backward of one (b, h) in one block, all five products on mma.sync.
// MT: the most 16-row tiles of Tq and of Tk the instance takes; a block has
// max(tiles(Tq), tiles(Tk)) warps. Phase 1, one warp per 16 query rows:
// S = Q.K^T, the mask and the softmax in f32 (P kept unrounded in
// registers); dP = dO.V^T key tile by key tile, twice (dsum over the
// unrounded P, then dS); the dropped P and dS go to shared memory in bf16
// and dQ = dS.K takes dS from registers. Phase 2, after one barrier, one
// warp per 16 key rows: dK = dS^T.Q and dV = dropped^T.dO through
// ldmatrix.trans of the two tiles.
template <int MT>
__global__ void __launch_bounds__(MT * 32)
masked_attention_bwd_mma_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const unsigned char* __restrict__ k_valid,
                                const unsigned char* __restrict__ keep,
                                float keep_prob, const bf16* __restrict__ dout,
                                bf16* __restrict__ dq, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, int H, int Tq, int Tk,
                                int Dh, float scale, int causal, int vec) {
  constexpr int MC = kMmaMaxDh / kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sc = row_stride(Dh, true), st = row_stride(Tk, true);
  const int ntq = tiles16(Tq), ntk = tiles16(Tk), nc = tiles16(Dh);
  bf16* qs = reinterpret_cast<bf16*>(smem + 16);
  bf16* dos = qs + Tq * sc;
  bf16* kss = dos + Tq * sc;
  bf16* vss = kss + Tk * sc;
  bf16* pss = vss + Tk * sc;
  bf16* dss = pss + Tq * st;
  const int bh = blockIdx.x;
  const size_t qoff = static_cast<size_t>(bh) * Tq * Dh;
  const size_t koff = static_cast<size_t>(bh) * Tk * Dh;
  stage(qs, q + qoff, Tq, Dh, sc, vec);
  stage(kss, k + koff, Tk, Dh, sc, vec);
  cp_async_commit();
  stage(vss, v + koff, Tk, Dh, sc, vec);
  stage(dos, dout + qoff, Tq, Dh, sc, vec);
  cp_async_commit();
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);
  cp_async_wait<1>();
  __syncthreads();

  const uint32_t zero = smem_u32(smem);
  const SmemMat tq{smem_u32(qs), zero, Tq, round8(Dh), sc};
  const SmemMat tdo{smem_u32(dos), zero, Tq, round8(Dh), sc};
  const SmemMat tk{smem_u32(kss), zero, Tk, round8(Dh), sc};
  const SmemMat tv{smem_u32(vss), zero, Tk, round8(Dh), sc};
  const SmemMat tp{smem_u32(pss), zero, Tq, round8(Tk), st};
  const SmemMat tds{smem_u32(dss), zero, Tq, round8(Tk), st};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = warp * kTile;  // phase 1 queries, phase 2 keys
  const unsigned char* valid = k_valid + static_cast<size_t>(bh / H) * Tk;
  const unsigned char* keep_bh =
      keep == nullptr ? nullptr : keep + static_cast<size_t>(bh) * Tq * Tk;
  const float kp_t = to_f32(from_f32<bf16>(keep_prob));  // keep in the type
  // a thread's element e of n8 key tile j: row i0 + g + 8 (e >> 1), key
  // 8j + 2 (lane & 3) + (e & 1)
  auto row_of = [&](int e) { return i0 + (lane >> 2) + 8 * (e >> 1); };
  auto key_of = [&](int j, int e) { return 8 * j + 2 * (lane & 3) + (e & 1); };
  // the keep mask at (row, key): 1 or 0 (1 without dropout)
  auto kept = [&](int row, int key) {
    return keep_bh == nullptr ||
           (row < Tq && key < Tk && keep_bh[row * Tk + key] != 0);
  };

  float s[2 * MT][4];
  if (warp < ntq) {
    score_tile<MT, MC>(s, tq, tk, i0, ntk, nc, lane);
    // the score rounded, then the additive mask (never a skip: a row whose
    // keys are all invalid spreads over all Tk keys); keys past Tk -> -inf
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_of(j, e);
        const int row = row_of(e);
        const bool ok = key < Tk && valid[key] != 0 && (!causal || key <= row);
        s[j][e] = key < Tk ? __fadd_rn(__fmul_rn(s[j][e], scale),
                                       ok ? 0.f : kBigNeg)
                           : -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e >> 1];
    // the dropped P in bf16: P rounded, then (P / keep) rounded, times
    // the mask
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      if (kk >= ntk) break;
      float d[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pt = to_f32(from_f32<bf16>(s[2 * kk + h][e]));
          d[h][e] = keep_bh == nullptr
                        ? pt
                        : (kept(row_of(e), key_of(2 * kk + h, e))
                               ? to_f32(from_f32<bf16>(pt / kp_t))
                               : 0.f);
        }
      uint32_t pa[4];
      acc_to_a(pa, d[0], d[1]);
      store_frag(pss, st, pa, i0, kk * kTile, Tq, round8(Tk), lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[2 * MC][4];
  if (warp < ntq) {
    uint32_t da[MC][4];  // the warp's dO rows as A fragments
#pragma unroll
    for (int kc = 0; kc < MC; ++kc)
      if (kc < nc) frag_a(da[kc], tdo, i0, kc * kTile, lane);
    // dP for keys 16kk.., times mask / keep_prob with dropout
    auto dp_tile = [&](float (&dp)[2][4], int kk) {
      dp_slice<MC>(dp, da, tv, kk, nc, lane);
      if (keep_bh != nullptr)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[h][e] = __fmul_rn(
                dp[h][e],
                (kept(row_of(e), key_of(2 * kk + h, e)) ? 1.f : 0.f) /
                    keep_prob);
    };
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      if (kk >= ntk) break;
      float dp[2][4];
      dp_tile(dp, kk);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsum[e >> 1] = fmaf(dp[h][e], s[2 * kk + h][e], dsum[e >> 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
      dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
    }
#pragma unroll
    for (int j = 0; j < 2 * MC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      if (kk >= ntk) break;
      float dp[2][4];
      dp_tile(dp, kk);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[h][e] = __fmul_rn(
              __fmul_rn(s[2 * kk + h][e], dp[h][e] - dsum[e >> 1]), scale);
      uint32_t dsa[4];  // dS rounded to bf16
      acc_to_a(dsa, dp[0], dp[1]);
      store_frag(dss, st, dsa, i0, kk * kTile, Tq, round8(Tk), lane);
#pragma unroll
      for (int cc = 0; cc < MC; ++cc) {
        if (cc >= nc) break;
        uint32_t b[4];
        frag_b_kn(b, tk, kk * kTile, cc * kTile, lane);
        mma16816(acc[2 * cc], dsa, b[0], b[1]);
        mma16816(acc[2 * cc + 1], dsa, b[2], b[3]);
      }
    }
    store_tile<MC>(acc, dq + qoff, i0, Tq, Dh, Dh, lane);
  }
  __syncthreads();

  if (warp >= ntk) return;
  // phase 2: one warp per 16 key rows i0.. -> dK = dS^T.Q, dV = dropped^T.dO
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const SmemMat& tile = which == 0 ? tds : tp;
    const SmemMat& rhs = which == 0 ? tq : tdo;
#pragma unroll
    for (int j = 0; j < 2 * MC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int qq = 0; qq < MT; ++qq) {
      if (qq >= ntq) break;
      uint32_t a[4];
      frag_a_t(a, tile, i0, qq * kTile, lane);
#pragma unroll
      for (int cc = 0; cc < MC; ++cc) {
        if (cc >= nc) break;
        uint32_t b[4];
        frag_b_kn(b, rhs, qq * kTile, cc * kTile, lane);
        mma16816(acc[2 * cc], a, b[0], b[1]);
        mma16816(acc[2 * cc + 1], a, b[2], b[3]);
      }
    }
    store_tile<MC>(acc, (which == 0 ? dk : dv) + koff, i0, Tk, Dh, Dh, lane);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int MT>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* k_valid, const void* keep, float keep_prob,
                   const void* dout, void* dq, void* dk, void* dv, int B,
                   int H, int Tq, int Tk, int Dh, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = mma_bwd_smem(Tq, Tk, Dh);
  const cudaError_t err =
      allow_smem(masked_attention_bwd_mma_kernel<MT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = Dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  const int warps = tiles16(Tq) > tiles16(Tk) ? tiles16(Tq) : tiles16(Tk);
  masked_attention_bwd_mma_kernel<MT><<<B * H, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(k_valid),
      static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, Dh, scale,
      causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------- bf16 forward, tensor cores

constexpr int kFwdMaxTk = 160;  // keys a warp's register-resident rows hold
constexpr int kFwdMaxDh = 64;   // Dh it takes (four 16-column tiles)
constexpr int kFwdWarps = 4;    // the most warps a block has (64 query rows)

// One 16-byte block of zeros, K and V [Tk][row_stride(Dh)] in bf16, then
// each key's additive mask in f32 [16 tiles16(Tk)]; Q goes from global
// memory straight to registers.
__host__ __device__ constexpr size_t mma_fwd_smem(int tk, int dh) {
  return 16 + 2 * static_cast<size_t>(tk) * row_stride(dh, true) * 2 +
         static_cast<size_t>(tiles16(tk)) * kTile * 4;
}
// within the 48 KB a block gets without opting in (46,736 bytes at most)
static_assert(mma_fwd_smem(kFwdMaxTk, kFwdMaxDh) <= 48 * 1024,
              "the tensor-core forward's limits exceed 48 KB");

// 1 where the forward takes the tensor-core kernel, 0 where the scalar one:
// by type and shape alone, any Tq.
inline int fwd_path(int dtype_code, int tk, int dh) {
  return dtype_code == 1 && tk <= kFwdMaxTk && dh <= kFwdMaxDh ? 1 : 0;
}

// Warps a block (16 query rows each): Tq's 16-row tiles spread evenly over
// the fewest blocks of at most kFwdWarps warps.
inline int fwd_warps(int tq) {
  const int t = tiles16(tq);
  const int blocks = (t + kFwdWarps - 1) / kFwdWarps;
  return (t + blocks - 1) / blocks;
}

// x / y from r = 1 / y (correctly rounded): the product, then one FMA
// correction. This is the correctly rounded quotient wherever it is above
// 1e-36 (tests/test_torch_attention.py holds an exact emulation to
// rational division at probabilities against row sums and keep
// probabilities), without the slow path that `/` takes for a zero
// numerator, which every masked key gives.
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// The A fragment of rows r0.., columns c0.. of a row-major [rows][cols]
// bf16 matrix in global memory, zero past its edges: 32-bit loads where
// `pairs` (cols even, base 4-byte aligned), else element by element.
__device__ __forceinline__ void frag_a_global(uint32_t (&a)[4], const bf16* m,
                                              int r0, int c0, int rows,
                                              int cols, bool pairs, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + (lane >> 2) + 8 * (e & 1);
    const int c = c0 + 2 * (lane & 3) + 8 * (e >> 1);
    uint32_t x = 0;
    if (r < rows && c < cols) {
      const bf16* p = m + static_cast<size_t>(r) * cols + c;
      if (pairs) {
        x = __ldg(reinterpret_cast<const unsigned int*>(p));
      } else {
        x = __bfloat16_as_ushort(p[0]);
        if (c + 1 < cols)
          x |= static_cast<uint32_t>(__bfloat16_as_ushort(p[1])) << 16;
      }
    }
    a[e] = x;
  }
}

// The forward of one (b, h) and 16 x (warps) query rows, both products on
// mma.sync. MT: the most 16-key tiles the instance takes; DROP: with a
// keep mask; CAUSAL: with the causal mask. K and V are staged once a block
// with cp.async, each key's additive mask (0, -1e9 for an invalid key, -inf
// past Tk) beside them. A warp holds its 16 rows' Q fragments, its
// keep-mask bits (loaded before the products) and its whole score rows in
// registers: S = Q.K^T, the score rounded, the mask added (-1e9 for a
// future key when causal), the row max and sum (quad shuffles), expf and
// the division by the sum, P rounded to bf16 (with dropout, (P / keep)
// rounded, times the mask) as it is repacked from the accumulator layout
// into A fragments for O = P.V through ldmatrix.trans of V; f32
// accumulation, one bf16 store.
template <int MT, bool DROP, bool CAUSAL>
__global__ void __launch_bounds__(kFwdWarps * 32)
masked_attention_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const unsigned char* __restrict__ k_valid,
                            const unsigned char* __restrict__ keep,
                            float keep_prob, bf16* __restrict__ out, int H,
                            int Tq, int Tk, int Dh, float scale, int vec,
                            int pairs, int keep16) {
  constexpr int MC = kFwdMaxDh / kTile;
  constexpr int NB = (8 * MT + 31) / 32;  // keep bits: 4 a thread's n8 tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int sc = row_stride(Dh, true);
  const int ntk = tiles16(Tk), nc = tiles16(Dh);
  bf16* kss = reinterpret_cast<bf16*>(smem + 16);
  bf16* vss = kss + Tk * sc;
  float* bias = reinterpret_cast<float*>(vss + Tk * sc);
  const int bh = blockIdx.x;
  const size_t koff = static_cast<size_t>(bh) * Tk * Dh;
  const size_t qoff = static_cast<size_t>(bh) * Tq * Dh;
  stage(kss, k + koff, Tk, Dh, sc, vec);
  cp_async_commit();
  stage(vss, v + koff, Tk, Dh, sc, vec);
  cp_async_commit();
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);
  const unsigned char* valid = k_valid + static_cast<size_t>(bh / H) * Tk;
  for (int i = threadIdx.x; i < ntk * kTile; i += blockDim.x)
    bias[i] = i < Tk ? (valid[i] != 0 ? 0.f : kBigNeg) : -INFINITY;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = (static_cast<int>(blockIdx.y) * (blockDim.x >> 5) + warp) *
                 kTile;
  // a thread's element e of n8 key tile j: row i0 + g + 8 (e >> 1), key
  // 8j + 2 (lane & 3) + (e & 1)
  auto row_of = [&](int e) { return i0 + (lane >> 2) + 8 * (e >> 1); };
  auto key_of = [&](int j, int e) { return 8 * j + 2 * (lane & 3) + (e & 1); };
  uint32_t qa[MC][4];  // the warp's Q rows as A fragments
  uint32_t kbits[NB];  // keep-mask bit 4j + e (DROP)
#pragma unroll
  for (int i = 0; i < NB; ++i) kbits[i] = 0;
  if (i0 < Tq) {
#pragma unroll
    for (int kc = 0; kc < MC; ++kc)
      if (kc < nc)
        frag_a_global(qa[kc], q + qoff, i0, kc * kTile, Tq, Dh, pairs != 0,
                      lane);
    if (DROP) {
      const unsigned char* keep_bh = keep + static_cast<size_t>(bh) * Tq * Tk;
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j) {
        if (j >= 2 * ntk) break;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          // keys 8j + 2 (lane & 3) and + 1 of one row: one 16-bit load
          // where Tk is even (and the mask 2-byte aligned)
          const int row = row_of(e), key = key_of(j, e);
          if (row >= Tq || key >= Tk) continue;
          const unsigned char* p =
              keep_bh + static_cast<size_t>(row) * Tk + key;
          uint32_t two;
          if (keep16) {
            two = *reinterpret_cast<const unsigned short*>(p);
            two = (two & 0xffu ? 1u : 0u) | (two >> 8 ? 2u : 0u);
          } else {
            two = (p[0] != 0 ? 1u : 0u) |
                  (key + 1 < Tk && p[1] != 0 ? 2u : 0u);
          }
          kbits[(4 * j + e) >> 5] |= two << ((4 * j + e) & 31);
        }
      }
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  const uint32_t zero = smem_u32(smem);
  const SmemMat tk{smem_u32(kss), zero, Tk, round8(Dh), sc};
  const SmemMat tv{smem_u32(vss), zero, Tk, round8(Dh), sc};
  float s[2 * MT][4];
  float sum[2] = {0.f, 0.f};
  if (i0 < Tq) {
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < MC; ++kc) {
      if (kc >= nc) break;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j >= ntk) break;
        uint32_t b[4];
        frag_b_nk(b, tk, j * kTile, kc * kTile, lane);
        mma16816(s[2 * j], qa[kc], b[0], b[1]);
        mma16816(s[2 * j + 1], qa[kc], b[2], b[3]);
      }
    }
    // the score rounded, then the additive mask (never a skip: a row whose
    // keys are all invalid spreads over all Tk keys, future ones included);
    // keys past Tk (the tiles' padding) get -inf, out of the max and sum
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      if (j >= 2 * ntk) break;
      const float2 kb =
          *reinterpret_cast<const float2*>(bias + key_of(j, 0));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float add = (e & 1) ? kb.y : kb.x;
        if (CAUSAL && key_of(j, e) > row_of(e)) add = fminf(add, kBigNeg);
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), add);
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      if (j >= 2 * ntk) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (i0 >= Tq) return;

  const float rinv[2] = {1.f / sum[0], 1.f / sum[1]};
  const float kp_t = to_f32(from_f32<bf16>(keep_prob));  // keep in the type
  const float rkp = 1.f / kp_t;
  float o[2 * MC][4];
#pragma unroll
  for (int j = 0; j < 2 * MC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    if (kk >= ntk) break;
    // P for keys 16kk.., rounded to bf16 as it is packed; with dropout P
    // rounded, then (P / keep) times the mask, rounded as it is packed
    float d[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 4 * (2 * kk + h) + e;
        float p = div_by(s[2 * kk + h][e], sum[e >> 1], rinv[e >> 1]);
        if (DROP)
          p = (kbits[bit >> 5] >> (bit & 31)) & 1u
                  ? div_by(to_f32(from_f32<bf16>(p)), kp_t, rkp)
                  : 0.f;
        d[h][e] = p;
      }
    uint32_t a[4];
    acc_to_a(a, d[0], d[1]);
#pragma unroll
    for (int cc = 0; cc < MC; ++cc) {
      if (cc >= nc) break;
      uint32_t b[4];
      frag_b_kn(b, tv, kk * kTile, cc * kTile, lane);
      mma16816(o[2 * cc], a, b[0], b[1]);
      mma16816(o[2 * cc + 1], a, b[2], b[3]);
    }
  }
  store_tile<MC>(o, out + qoff, i0, Tq, Dh, Dh, lane);
}

template <int MT, bool DROP, bool CAUSAL>
int launch_fwd_mma(const void* q, const void* k, const void* v,
                   const void* k_valid, const void* keep, float keep_prob,
                   void* out, int B, int H, int Tq, int Tk, int Dh,
                   float scale, cudaStream_t stream) {
  const size_t smem = mma_fwd_smem(Tk, Dh);
  const int vec = Dh % 8 == 0 && aligned16(k) && aligned16(v);
  const int pairs =
      Dh % 2 == 0 && (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  const int keep16 =
      Tk % 2 == 0 && (reinterpret_cast<uintptr_t>(keep) & 1) == 0;
  const int warps = fwd_warps(Tq);
  const dim3 grid(B * H, (tiles16(Tq) + warps - 1) / warps);
  masked_attention_mma_kernel<MT, DROP, CAUSAL>
      <<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(k_valid),
      static_cast<const unsigned char*>(keep), keep_prob,
      static_cast<bf16*>(out), H, Tq, Tk, Dh, scale, vec, pairs, keep16);
  return static_cast<int>(cudaGetLastError());
}

// the instance for a keep mask or none, causal or not
template <int MT>
int launch_fwd_mma_for(const void* q, const void* k, const void* v,
                       const void* k_valid, const void* keep, float keep_prob,
                       void* out, int B, int H, int Tq, int Tk, int Dh,
                       float scale, int causal, cudaStream_t stream) {
  const auto run =
      keep != nullptr
          ? (causal ? launch_fwd_mma<MT, true, true>
                    : launch_fwd_mma<MT, true, false>)
          : (causal ? launch_fwd_mma<MT, false, true>
                    : launch_fwd_mma<MT, false, false>);
  return run(q, k, v, k_valid, keep, keep_prob, out, B, H, Tq, Tk, Dh, scale,
             stream);
}

}  // namespace

extern "C" {

// Shared memory one launch of the scalar forward needs at (Dh, Tk): within
// the card's limit for every Dh <= 128 and every Tk;
// kernels/attention.py fwd_smem_bytes mirrors it.
long long asr_masked_attention_smem(int dtype_code, int dh, int tk) {
  return static_cast<long long>(dtype_code == 1
                                    ? smem_bytes<__nv_bfloat16>(dh, tk)
                                    : smem_bytes<float>(dh, tk));
}

// 1 where the forward at (Tq, Tk, Dh) takes the tensor-core kernel, 0
// where the scalar one; kernels/attention.py fwd_path mirrors it.
int asr_masked_attention_path(int dtype_code, int tq, int tk, int dh) {
  (void)tq;  // any Tq
  return fwd_path(dtype_code, tk, dh);
}

// Shared memory of the tensor-core forward at (Tk, Dh).
long long asr_masked_attention_mma_smem(int tk, int dh) {
  return static_cast<long long>(mma_fwd_smem(tk, dh));
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
  if (fwd_path(dtype_code, Tk, Dh) == 1) {
    const int nt = tiles16(Tk);
    return (nt <= 4 ? launch_fwd_mma_for<4>
                    : nt <= 7 ? launch_fwd_mma_for<7>
                              : launch_fwd_mma_for<10>)(
        q, k, v, k_valid, keep, keep_prob, out, B, H, Tq, Tk, Dh, scale,
        causal, s);
  }
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

// 1 where the backward at (Tq, Tk, Dh) takes the one-block tensor-core
// kernel, 0 where the two chunked launches; kernels/attention.py bwd_path
// mirrors it.
int asr_masked_attention_bwd_path(int dtype_code, int tq, int tk, int dh) {
  return bwd_path(dtype_code, tq, tk, dh);
}

// Shared memory of the tensor-core backward at (Tq, Tk, Dh).
long long asr_masked_attention_bwd_mma_smem(int tq, int tk, int dh) {
  return static_cast<long long>(mma_bwd_smem(tq, tk, dh));
}

// The backward: q, dout [B, H, Tq, Dh], k/v [B, H, Tk, Dh], k_valid, keep
// as the forward -> dq [B, H, Tq, Dh], dk / dv [B, H, Tk, Dh], all in the
// input type; stats is an f32 scratch of 3 * B * H * Tq (each query row's
// max, sum and dsum, written by the first launch and read by the second)
// on the chunked path, unused (and may be null) on the tensor-core one.
int asr_masked_attention_bwd(int dtype_code, const void* q, const void* k,
                             const void* v, const void* k_valid,
                             const void* keep, float keep_prob,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int Tq, int Tk,
                             int Dh, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd_path(dtype_code, Tq, Tk, Dh) == 1)
    return (Tq <= 64 && Tk <= 64 ? launch_bwd_mma<4> : launch_bwd_mma<10>)(
        q, k, v, k_valid, keep, keep_prob, dout, dq, dk, dv, B, H, Tq, Tk,
        Dh, scale, causal, s);
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
