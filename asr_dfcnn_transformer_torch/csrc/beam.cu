// CTC prefix beam search for the PyTorch port, the whole search in one
// kernel with its state in shared memory.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/beam_kernel.py:beam_search
// (the row-major _beam_kernel and the batch-on-lanes _beam_kernel_t) with
// the semantics of the scan backend, ops/ctc_decode.py _beam_state_init /
// _make_beam_step, exactly:
//   - beam 0 starts as the live empty prefix; dead beams carry the sentinel
//     hashes w + 0x7fffffff and w + 0x1fffffff;
//   - each frame, each of W beams yields one stay candidate and K extend
//     candidates (beam-major: candidate W + w * K + k extends beam w by
//     top_ids[k]), M = W (K + 1) in all;
//   - prefixes are identified by a double rolling hash, uint32 with
//     wrap-around: h * 2654435761 + (symbol + 2) and h * 40503 + (symbol + 2);
//   - duplicates merge through the masked logsumexp with NEG_INF = -1e30
//     and the mx <= NEG_INF / 2 readout; only a prefix's first occurrence
//     keeps its total;
//   - the top W survive in lax.top_k order (descending, ties to the lower
//     candidate index), found by a rank count with no serial pick loop;
//   - a survivor's prefix is its source beam's, with the added symbol
//     written at min(source length, L - 1);
//   - an utterance's state freezes from frame len on.
// logaddexp is torch.logaddexp's formula (max + log1p(exp(-|a - b|)), equal
// infinities pass through); built without --use_fast_math, so expf, logf
// and log1pf are the accurate versions the twin's torch ops call.
//
// Bound: latency. The search is a chain of T (<= 200) dependent frames per
// utterance, and one frame's work is tiny (M = 72 candidates, an M x M hash
// compare); the bytes are W + K + 1 floats a frame of the log-probs and the
// top-k tables, a few MB in all. At B <= 8 only B of 132 SMs have work.
// Design: one block per utterance, four neighbouring threads per candidate
// (288 threads at W = K = 8: the M x M passes take 18 steps, not 72, with
// nine warps to hide the shared-memory latency); the beam state, the
// candidates and the prefixes (double-buffered, 2 x W x L ints = 6.4 KB at
// W 8, L 100) live in shared memory, five barriers a frame. Each
// candidate's two hashes are packed into one 64-bit key for the M x M
// compare, and only equal keys are summed. The frame loop stops at the
// utterance's length, which is what the freeze amounts to.
// Not carried over from the TPU: the two layouts (they exist for Mosaic's
// tiling limits; a block per utterance needs neither), and the full-row DMA
// of lp[b, t, :] (a block reads just the W + 1 entries it needs, lp[b, t,
// last[w]] and lp[b, t, blank], straight from device memory).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr uint32_t kMul1 = 2654435761u;
constexpr uint32_t kMul2 = 40503u;
constexpr int kLanes = 4;  // threads per candidate (a power of two <= 32)
constexpr int kMaxCandidates = 1024 / kLanes;

__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

struct Smem {
  unsigned long long* c_key;  // [M] (h1 << 32) | h2 of each candidate
  int* pref;      // [2][W][L]
  float* b_pb;    // [W] beam state
  float* b_pnb;
  uint32_t* b_h1;
  uint32_t* b_h2;
  int* b_len;
  float* c_pb;    // [M] candidates
  float* c_pnb;
  uint32_t* c_h1;
  uint32_t* c_h2;
  int* c_len;
  int* c_src;
  int* c_add;
  float* m_pb;    // [M] merged scores and totals
  float* m_pnb;
  float* tot;
  int* slot;      // [W] candidate picked for each new beam
  int* s_src;     // [W] source beam, added symbol, append position
  int* s_add;
  int* s_pos;
};

__host__ __device__ size_t smem_words(int W, int K, int L) {
  const size_t M = static_cast<size_t>(W) * (K + 1);
  return 2 * M + 2 * static_cast<size_t>(W) * L + 5 * W + 10 * M + 4 * W;
}

__device__ Smem carve(void* base, int W, int K, int L) {
  const int M = W * (K + 1);
  Smem s;
  s.c_key = static_cast<unsigned long long*>(base);  // 8-byte aligned first
  uint32_t* p = reinterpret_cast<uint32_t*>(s.c_key + M);
  s.pref = reinterpret_cast<int*>(p); p += 2 * W * L;
  s.b_pb = reinterpret_cast<float*>(p); p += W;
  s.b_pnb = reinterpret_cast<float*>(p); p += W;
  s.b_h1 = p; p += W;
  s.b_h2 = p; p += W;
  s.b_len = reinterpret_cast<int*>(p); p += W;
  s.c_pb = reinterpret_cast<float*>(p); p += M;
  s.c_pnb = reinterpret_cast<float*>(p); p += M;
  s.c_h1 = p; p += M;
  s.c_h2 = p; p += M;
  s.c_len = reinterpret_cast<int*>(p); p += M;
  s.c_src = reinterpret_cast<int*>(p); p += M;
  s.c_add = reinterpret_cast<int*>(p); p += M;
  s.m_pb = reinterpret_cast<float*>(p); p += M;
  s.m_pnb = reinterpret_cast<float*>(p); p += M;
  s.tot = reinterpret_cast<float*>(p); p += M;
  s.slot = reinterpret_cast<int*>(p); p += W;
  s.s_src = reinterpret_cast<int*>(p); p += W;
  s.s_add = reinterpret_cast<int*>(p); p += W;
  s.s_pos = reinterpret_cast<int*>(p); p += W;
  return s;
}

__global__ void beam_search_kernel(const float* __restrict__ lp,
                                   const float* __restrict__ top_lp,
                                   const int* __restrict__ top_ids,
                                   const int* __restrict__ lens,
                                   int* __restrict__ prefixes_out,
                                   int* __restrict__ plen_out,
                                   float* __restrict__ pb_out,
                                   float* __restrict__ pnb_out, int T, int V,
                                   int W, int K, int blank, int L) {
  extern __shared__ unsigned long long smem_raw[];
  const Smem s = carve(smem_raw, W, K, L);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int M = W * (K + 1);
  const int WL = W * L;

  for (int e = tid; e < WL; e += nthreads) s.pref[e] = 0;
  if (tid < W) {
    s.b_pb[tid] = tid == 0 ? 0.f : kNegInf;
    s.b_pnb[tid] = kNegInf;
    s.b_h1[tid] = tid == 0 ? 0u : static_cast<uint32_t>(tid) + 0x7fffffffu;
    s.b_h2[tid] = tid == 0 ? 0u : static_cast<uint32_t>(tid) + 0x1fffffffu;
    s.b_len[tid] = 0;
  }
  __syncthreads();

  const int t_end = min(T, max(lens[b], 0));  // frozen from len on
  // kLanes neighbouring threads share a candidate: lane q == 0 builds it,
  // and in the M x M passes lane q takes the j = q mod kLanes
  const int cand = tid / kLanes;
  const int q = tid % kLanes;
  const bool is_cand = cand < M;
  // the candidate: a stay (beam cand) or an extension (beam w by the
  // symbol in top-k slot kk)
  const bool is_stay = cand < W;
  const int w = is_stay ? cand : (cand - W) / K;
  const int kk = is_stay ? 0 : (cand - W) % K;
  int cur = 0;
  for (int t = 0; t < t_end; ++t) {
    const size_t frame = static_cast<size_t>(b) * T + t;
    const float* lp_t = lp + frame * V;
    // ---- candidates ----
    if (is_cand && q == 0) {
      const float pb = s.b_pb[w];
      const float pnb = s.b_pnb[w];
      const int plen = s.b_len[w];
      const int last =
          plen > 0 ? s.pref[(cur * W + w) * L + plen - 1] : -1;
      const float tot = logaddexp(pb, pnb);
      uint32_t h1 = s.b_h1[w], h2 = s.b_h2[w];
      if (is_stay) {
        s.c_pb[cand] = tot + lp_t[blank];
        s.c_pnb[cand] = plen > 0 ? pnb + lp_t[last] : kNegInf;
        s.c_len[cand] = plen;
        s.c_add[cand] = -1;
      } else {
        const int c = top_ids[frame * K + kk];
        const float base = c == last ? pb : tot;
        float ext = base + top_lp[frame * K + kk];
        if (c == blank || plen >= L) ext = kNegInf;
        const uint32_t cid = static_cast<uint32_t>(c) + 2u;
        h1 = h1 * kMul1 + cid;
        h2 = h2 * kMul2 + cid;
        s.c_pb[cand] = kNegInf;
        s.c_pnb[cand] = ext;
        s.c_len[cand] = min(plen + 1, L);
        s.c_add[cand] = c;
      }
      s.c_h1[cand] = h1;
      s.c_h2[cand] = h2;
      s.c_src[cand] = w;
      s.c_key[cand] = (static_cast<unsigned long long>(h1) << 32) | h2;
    }
    __syncthreads();
    // ---- merge duplicates: masked logsumexp over equal (h1, h2) ----
    // A candidate j of another prefix enters the twin's sums as the fill
    // NEG_INF: it never raises the max above NEG_INF, and its term
    // expf(NEG_INF - max(mx, NEG_INF / 2)) is exactly 0, so skipping it
    // leaves every result the same. The lanes' partial maxima, flags and
    // rank counts combine exactly; their partial sums are added in another
    // order than one serial sum, which changes nothing while a prefix has
    // at most two live candidates.
    const unsigned long long key = is_cand ? s.c_key[cand] : 0ull;
    float mx_pb = kNegInf, mx_pnb = kNegInf;
    int dup = 0;
    if (is_cand) {
      for (int j = q; j < M; j += kLanes) {
        if (s.c_key[j] == key) {
          mx_pb = fmaxf(mx_pb, s.c_pb[j]);
          mx_pnb = fmaxf(mx_pnb, s.c_pnb[j]);
          dup |= j < cand;
        }
      }
    }
    for (int off = 1; off < kLanes; off <<= 1) {  // every lane takes part
      mx_pb = fmaxf(mx_pb, __shfl_xor_sync(0xffffffffu, mx_pb, off));
      mx_pnb = fmaxf(mx_pnb, __shfl_xor_sync(0xffffffffu, mx_pnb, off));
      dup |= __shfl_xor_sync(0xffffffffu, dup, off);
    }
    const float safe_pb = fmaxf(mx_pb, kNegInf / 2);
    const float safe_pnb = fmaxf(mx_pnb, kNegInf / 2);
    float sum_pb = 0.f, sum_pnb = 0.f;
    if (is_cand) {
      for (int j = q; j < M; j += kLanes) {
        if (s.c_key[j] == key) {
          sum_pb += expf(s.c_pb[j] - safe_pb);
          sum_pnb += expf(s.c_pnb[j] - safe_pnb);
        }
      }
    }
    for (int off = 1; off < kLanes; off <<= 1) {
      sum_pb += __shfl_xor_sync(0xffffffffu, sum_pb, off);
      sum_pnb += __shfl_xor_sync(0xffffffffu, sum_pnb, off);
    }
    if (is_cand && q == 0) {
      const float mpb =
          mx_pb <= kNegInf / 2 ? kNegInf : safe_pb + logf(sum_pb);
      const float mpnb =
          mx_pnb <= kNegInf / 2 ? kNegInf : safe_pnb + logf(sum_pnb);
      s.m_pb[cand] = mpb;
      s.m_pnb[cand] = mpnb;
      s.tot[cand] = dup ? kNegInf : logaddexp(mpb, mpnb);
    }
    if (tid < W) s.slot[tid] = tid;  // overwritten below unless NaN
    __syncthreads();
    // ---- top W by rank: lax.top_k's order ----
    int rank = 0;
    if (is_cand) {
      const float ti = s.tot[cand];
      for (int j = q; j < M; j += kLanes) {
        const float tj = s.tot[j];
        rank += (tj > ti) || (tj == ti && j < cand);
      }
    }
    for (int off = 1; off < kLanes; off <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (is_cand && q == 0 && rank < W) s.slot[rank] = cand;
    __syncthreads();
    // ---- the new beams ----
    if (tid < W) {
      const int c = s.slot[tid];
      const int src = s.c_src[c];
      s.b_pb[tid] = s.m_pb[c];
      s.b_pnb[tid] = s.m_pnb[c];
      s.b_h1[tid] = s.c_h1[c];
      s.b_h2[tid] = s.c_h2[c];
      s.b_len[tid] = s.c_len[c];
      s.s_src[tid] = src;
      s.s_add[tid] = s.c_add[c];
      // candidate src is the source beam's stay: its length is the source's
      s.s_pos[tid] = min(s.c_len[src], L - 1);
    }
    __syncthreads();
    // ---- rebuild the prefixes into the other buffer ----
    {
      const int* old_pref = s.pref + cur * WL;
      int* new_pref = s.pref + (cur ^ 1) * WL;
      for (int e = tid; e < WL; e += nthreads) {
        const int nw = e / L;
        const int l = e - nw * L;
        const int add = s.s_add[nw];
        new_pref[e] = (add >= 0 && l == s.s_pos[nw])
                          ? add
                          : old_pref[s.s_src[nw] * L + l];
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  const size_t out = static_cast<size_t>(b) * WL;
  for (int e = tid; e < WL; e += nthreads)
    prefixes_out[out + e] = s.pref[cur * WL + e];
  if (tid < W) {
    plen_out[b * W + tid] = s.b_len[tid];
    pb_out[b * W + tid] = s.b_pb[tid];
    pnb_out[b * W + tid] = s.b_pnb[tid];
  }
}

}  // namespace

extern "C" {

// lp [B, T, V] f32, top_lp [B, T, K] f32, top_ids [B, T, K] int32,
// lens [B] int32 -> prefixes [B, W, L] int32, plen [B, W] int32,
// pb / pnb [B, W] f32. Takes W (K + 1) <= 256 candidates (one block) and
// a state of at most 227 KB of shared memory; other sizes return
// cudaErrorInvalidValue.
int asr_beam_search(const void* lp, const void* top_lp, const void* top_ids,
                    const void* lens, void* prefixes, void* plen, void* pb,
                    void* pnb, int B, int T, int V, int W, int K, int blank,
                    int L, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || K <= 0 || L <= 0 || V <= 0 || T < 0 || blank < 0 ||
      blank >= V || W * (K + 1) > kMaxCandidates)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_words(W, K, L) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        beam_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int threads = (kLanes * W * (K + 1) + 31) / 32 * 32;
  beam_search_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(top_lp),
      static_cast<const int*>(top_ids), static_cast<const int*>(lens),
      static_cast<int*>(prefixes), static_cast<int*>(plen),
      static_cast<float*>(pb), static_cast<float*>(pnb), T, V, W, K, blank,
      L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
