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
// Bound: latency. The search is a chain of T (<= 200 on the served path)
// dependent frames per utterance, and one frame's work is tiny (M = 72
// candidates, an M x M comparison); the bytes are a few MB in all, and at
// B <= 8 only B of 132 SMs have work. So the kernel's time is the frame's
// critical path times T. The earlier design's frame (clock64 stamps per
// stage on an NVIDIA H100 80GB HBM3 at 700 W) went to the two merge passes
// over all M candidates (21% and 29%), the rank pass (17%), the rebuild of
// the W x L prefix table (17%), the candidate build with its dependent
// device-memory loads (12%) and the new beams (4%), behind five barriers.
// This design's frame is still a latency chain (dependent shared-memory
// loads, shuffles and accurate transcendentals between three barriers):
// ~1.35 us at the path case (lp [8, 200, 1536], W = K = 8, L 100: 269 us
// against 693) and ~1.75 us on the served batch's lattice, where symbols
// persist over frames and most prefixes merge two candidates (352 us
// against 728), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
// Design, per block (one utterance, four neighbouring threads a candidate,
// 288 threads at W = K = 8), three barriers a frame:
//   - the frame inputs come off the chain: the log-prob row, top_lp and
//     top_ids of the frames ahead are copied into a ring of kStages slots
//     in shared memory, by three bulk copies (the TMA's non-tensor form)
//     completing on the slot's mbarrier where the rows are 16-byte
//     aligned, else by 4-byte cp.async, while earlier frames compute; so
//     lp[t, last] and lp[t, blank] are shared-memory reads;
//   - each beam keeps its last symbol and logaddexp(pb, pnb) in its state
//     (written by the candidate that wins its slot, from values it has in
//     registers), so a candidate is a few adds and two hash updates;
//   - no prefix table: the winner of each slot records a back-pointer
//     (source beam, whether it extended, whether its source was at the
//     cap, the added symbol) in a [B, T, W] scratch, and one trace-back at
//     the end writes each beam's prefix: an extension's position is the
//     child's length - 1, and the latest write along the lineage wins at
//     L - 1;
//   - no M x M match pass: each candidate sets its bit in a bucket of a
//     512-entry table by its (h1, h2); one pass over the bucket's other
//     members, checked on both hashes, gives the prefix's maxima. A prefix
//     with one candidate merges to its own scores (the masked logsumexp of
//     one term is the term + 0). A prefix with several sums its members
//     in the order the earlier kernel's lane-partial sums took (by j mod 4
//     in increasing j, then (s0 + s1) + (s2 + s3)), which for two members
//     (a stay and the extension that reaches its prefix, the common case
//     on speech, where symbols persist over frames) is one term plus the
//     other, taken from registers; a term at the max is expf(0) = 1, one
//     at NEG_INF is 0, and a sum of 1 reads out as the max + 0, so every
//     output is the same bit for bit; where one side of logaddexp(pb, pnb)
//     is NEG_INF the other comes out + 0 without the transcendentals;
//   - the rank pass compares one u64 key per candidate (the total's order,
//     then the lower index: lax.top_k's order), read 16 bytes at a time
//     from rows kept transposed by lane, and the candidate ranked r < W
//     writes new beam r itself;
//   - W = K = 8 has an instance of its own (loops of known trip count).
// Tried and dropped: per-lane bitmasks of equal keys over the M x M
// compare (slower with 64-bit keys; with 32-bit hashes and transposed rows
// no faster than the buckets, and O(M^2)); eight lanes a candidate and two
// (in the old design a little faster and much slower); 16-byte cp.async
// of the rows by every thread (as fast as the bulk copies, 384
// instructions a frame against three); two ring slots (slower); buckets
// holding a count (atomicAdd) and two indices in place of the masks
// (slower: an atomic with a return on the chain).
// Not carried over from the TPU: the two layouts (they exist for Mosaic's
// tiling limits; a block per utterance needs neither).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr uint32_t kMul1 = 2654435761u;
constexpr uint32_t kMul2 = 40503u;
constexpr int kLanes = 4;  // threads per candidate (a power of two <= 32)
constexpr int kMaxThreads = 1024;
constexpr int kMaxCandidates = kMaxThreads / kLanes;  // 256
constexpr int kStages = 4;       // frames of inputs in shared memory
constexpr int kBpChunk = 2048;   // back-pointers staged at a time
constexpr int kBucketShift = 23;  // 512 buckets of candidates by prefix
constexpr int kBuckets = 1 << (32 - kBucketShift);
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit of sm_90
// back-pointer bits: source beam (W <= 128), extension, source at the cap,
// then the added symbol
constexpr int kSrcMask = 0x7f;
constexpr int kExtBit = 0x80;
constexpr int kCapBit = 0x100;
constexpr int kAddShift = 9;

__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// 32-bit words of one ring slot: the log-prob row, top_lp and top_ids,
// each padded to 16 bytes.
__host__ __device__ inline int slot_words(int V, int K) {
  return (V + 3) / 4 * 4 + 2 * ((K + 3) / 4 * 4);
}

// The rank pass: lane q of a candidate compares it with candidates j = q +
// kLanes i, i < nj; the rank keys are kept transposed, lane row q first,
// so that those j sit side by side (16-byte loads). A row holds nj
// entries, padded to a multiple of four.
__host__ __device__ inline int row_len(int W, int K) {
  const int nj = (W * (K + 1) + kLanes - 1) / kLanes;
  return (nj + 3) / 4 * 4;
}

// Candidates by prefix: a bucket per (h1, h2) hash, holding a mask of the
// candidates' indices (words of 32).
__host__ __device__ inline int mask_words(int W, int K) {
  return (W * (K + 1) + 31) / 32;
}

__device__ __forceinline__ int bucket_of(uint32_t h1, uint32_t h2) {
  return static_cast<int>(((h1 ^ (h2 * kMul2)) * kMul1) >> kBucketShift);
}

// Where candidate j sits in the transposed arrays.
__device__ __forceinline__ int cpos(int j, int row) {
  return (j % kLanes) * row + j / kLanes;
}

// Reserves `bytes` at `off` (kept 16-byte aligned) and returns its offset.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off = align16(off + bytes);
  return at;
}

// Shared memory, in this order: an mbarrier per ring slot; the buckets'
// candidate masks [kBuckets][words] u32; the candidates' rank keys
// [kLanes][row] u64, hashes h1 and h2 [M] u32, pb and pnb [M] f32;
// the beams' pb, pnb, logaddexp(pb, pnb) [W] f32, h1, h2 [W] u32, length
// and last symbol [W] int; the ring [kStages][slot]; the trace-back's
// back-pointer chunk [kBpChunk] int.
struct Layout {
  size_t bars, tab, rk, ch1, ch2, cpb, cpnb, bpb, bpnb, btot, bh1, bh2, blen,
      blast, ring, bpc, total;
  __host__ __device__ Layout(int W, int K, int V) {
    const size_t M = static_cast<size_t>(W) * (K + 1);
    const size_t n = static_cast<size_t>(kLanes) * row_len(W, K);
    const size_t w4 = static_cast<size_t>(W) * 4;
    size_t off = 0;
    bars = take(off, kStages * 8);
    tab = take(off, static_cast<size_t>(kBuckets) * mask_words(W, K) * 4);
    rk = take(off, n * 8);
    ch1 = take(off, M * 4);
    ch2 = take(off, M * 4);
    cpb = take(off, M * 4);
    cpnb = take(off, M * 4);
    bpb = take(off, w4);
    bpnb = take(off, w4);
    btot = take(off, w4);
    bh1 = take(off, w4);
    bh2 = take(off, w4);
    blen = take(off, w4);
    blast = take(off, w4);
    ring = take(off, static_cast<size_t>(kStages) * slot_words(V, K) * 4);
    bpc = take(off, static_cast<size_t>(kBpChunk) * 4);
    total = off;
  }
};

// A float's order as a uint32 (larger float, larger key); -0 counts as +0,
// so that the two tie as the float compare has them.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "BEAM_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra BEAM_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy (the TMA's non-tensor form) of `bytes` (a multiple of 16,
// both ends 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Starts the copy of frame t's inputs (lp[b, t, :], top_lp[b, t, :],
// top_ids[b, t, :]) into `slot`. Bulk: three copies by one thread,
// completing on the slot's mbarrier. Otherwise (rows not 16-byte aligned)
// 4-byte cp.async by every thread, one commit group a frame.
__device__ __forceinline__ void stage_frame(float* slot, uint64_t* bar,
                                            const float* lp_row,
                                            const float* tlp, const int* tids,
                                            int V, int K, bool bulk) {
  const int vp = (V + 3) / 4 * 4;
  const int kp = (K + 3) / 4 * 4;
  if (bulk) {
    // the block's last thread: a rank lane that stores nothing, so the
    // fence below waits on no store of its own
    if (threadIdx.x == blockDim.x - 1) {
      // the slot's earlier generic reads before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)),
          "r"(4 * (V + 2 * K))
          : "memory");
      bulk_copy(slot, lp_row, 4 * V, bar);
      bulk_copy(slot + vp, tlp, 4 * K, bar);
      bulk_copy(slot + vp + kp, tids, 4 * K, bar);
    }
    return;
  }
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    cp_async4(slot + i, lp_row + i);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    cp_async4(slot + vp + i, tlp + i);
    cp_async4(slot + vp + kp + i, tids + i);
  }
  cp_async_commit();
}

// kW, kK > 0: an instance for those widths (loops of known trip count,
// unrolled); 0: any width, from the arguments.
template <int kW, int kK>
__global__ void __launch_bounds__(
    kW > 0 ? (kLanes * kW * (kK + 1) + 31) / 32 * 32 : kMaxThreads)
beam_search_kernel(const float* __restrict__ lp,
                   const float* __restrict__ top_lp,
                   const int* __restrict__ top_ids,
                   const int* __restrict__ lens, int* bp,
                   int* __restrict__ prefixes_out, int* __restrict__ plen_out,
                   float* __restrict__ pb_out, float* __restrict__ pnb_out,
                   int T, int V, int W_, int K_, int blank, int L, int bulk) {
  constexpr bool kFixed = kW > 0;
  // mask words of a bucket, a bound known to the compiler
  constexpr int kWords =
      kFixed ? (kW * (kK + 1) + 31) / 32 : kMaxCandidates / 32;
  const int W = kFixed ? kW : W_;
  const int K = kFixed ? kK : K_;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(W, K, V);
  auto* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  auto* tab = reinterpret_cast<uint32_t*>(smem + lay.tab);
  auto* c_rk = reinterpret_cast<unsigned long long*>(smem + lay.rk);
  auto* c_h1 = reinterpret_cast<uint32_t*>(smem + lay.ch1);
  auto* c_h2 = reinterpret_cast<uint32_t*>(smem + lay.ch2);
  auto* c_pb = reinterpret_cast<float*>(smem + lay.cpb);
  auto* c_pnb = reinterpret_cast<float*>(smem + lay.cpnb);
  auto* b_pb = reinterpret_cast<float*>(smem + lay.bpb);
  auto* b_pnb = reinterpret_cast<float*>(smem + lay.bpnb);
  auto* b_tot = reinterpret_cast<float*>(smem + lay.btot);
  auto* b_h1 = reinterpret_cast<uint32_t*>(smem + lay.bh1);
  auto* b_h2 = reinterpret_cast<uint32_t*>(smem + lay.bh2);
  auto* b_len = reinterpret_cast<int*>(smem + lay.blen);
  auto* b_last = reinterpret_cast<int*>(smem + lay.blast);
  auto* ring = reinterpret_cast<float*>(smem + lay.ring);
  auto* bpc = reinterpret_cast<int*>(smem + lay.bpc);
  const int sw = slot_words(V, K);
  const int vp = (V + 3) / 4 * 4;
  const int kp = (K + 3) / 4 * 4;
  const int M = W * (K + 1);
  const int row = row_len(W, K);
  const int words = mask_words(W, K);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int t_end = min(T, max(lens[b], 0));  // frozen from len on
  const size_t frame0 = static_cast<size_t>(b) * T;

  // rank keys 0 in the rows' padding: no candidate's key is below it
  for (int e = tid; e < kLanes * row; e += blockDim.x) c_rk[e] = 0ull;
  for (int e = tid; e < kBuckets * words; e += blockDim.x) tab[e] = 0u;
  if (tid < W) {
    const float pb = tid == 0 ? 0.f : kNegInf;
    b_pb[tid] = pb;
    b_pnb[tid] = kNegInf;
    b_tot[tid] = logaddexp(pb, kNegInf);
    b_h1[tid] = tid == 0 ? 0u : static_cast<uint32_t>(tid) + 0x7fffffffu;
    b_h2[tid] = tid == 0 ? 0u : static_cast<uint32_t>(tid) + 0x1fffffffu;
    b_len[tid] = 0;
    b_last[tid] = -1;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the inputs of frames 0 .. kStages - 2 in flight; without the bulk
  // copies one commit group a frame, empty past t_end, so that the wait
  // below counts frames
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < t_end) {
      const size_t f = frame0 + s;
      stage_frame(ring + s * sw, bars + s, lp + f * V, top_lp + f * K,
                  top_ids + f * K, V, K, bulk != 0);
    } else if (!bulk) {
      cp_async_commit();
    }
  }

  // kLanes neighbouring threads share a candidate: each forms it, and in
  // the M x M passes lane q takes the j = q mod kLanes
  const int cand = tid / kLanes;
  const int q = tid % kLanes;
  const bool is_cand = cand < M;
  const int my_pos = cpos(cand, row);
  // the candidate: a stay (beam cand) or an extension (beam w by the
  // symbol in top-k slot kk)
  const bool is_stay = cand < W;
  const int w = is_stay ? cand : (cand - W) / K;
  const int kk = is_stay ? 0 : (cand - W) % K;
  for (int t = 0; t < t_end; ++t) {
    if (bulk)  // the (t / kStages)-th use of the slot's mbarrier
      mbar_wait(bars + t % kStages, (t / kStages) & 1);
    else
      cp_async_wait<kStages - 2>();  // this thread's copies of frame t
    __syncthreads();  // everyone's, and the beams of frame t - 1
    const float* in = ring + (t % kStages) * sw;
    const float* tlp = in + vp;
    const int* tids = reinterpret_cast<const int*>(tlp + kp);
    // ---- the candidate ----
    float cpb = kNegInf, cpnb = kNegInf;
    uint32_t h1 = 0, h2 = 0;
    int plen = 0, last = -1, clen = 0, add = -1;
    if (is_cand) {
      const float pb = b_pb[w];
      const float pnb = b_pnb[w];
      const float tot = b_tot[w];
      plen = b_len[w];
      last = b_last[w];
      h1 = b_h1[w];
      h2 = b_h2[w];
      if (is_stay) {
        cpb = tot + in[blank];
        cpnb = plen > 0 ? pnb + in[last] : kNegInf;
        clen = plen;
      } else {
        const int c = tids[kk];
        const float base = c == last ? pb : tot;
        float ext = base + tlp[kk];
        if (c == blank || plen >= L) ext = kNegInf;
        const uint32_t cid = static_cast<uint32_t>(c) + 2u;
        h1 = h1 * kMul1 + cid;
        h2 = h2 * kMul2 + cid;
        cpnb = ext;
        clen = min(plen + 1, L);
        add = c;
      }
      if (q == 0) {
        c_h1[cand] = h1;
        c_h2[cand] = h2;
        c_pb[cand] = cpb;
        c_pnb[cand] = cpnb;
        atomicOr(tab + bucket_of(h1, h2) * words + cand / 32,
                 1u << (cand % 32));
      }
    }
    __syncthreads();
    // ---- merge duplicates: masked logsumexp over equal (h1, h2) ----
    // A candidate j of another prefix enters the twin's sums as the fill
    // NEG_INF: it never raises the max above NEG_INF, and its term
    // expf(NEG_INF - max(mx, NEG_INF / 2)) is exactly 0, so skipping it
    // leaves every result the same. The candidates of a prefix share a
    // bucket; the bucket's other members are checked on both hashes.
    const int bucket = bucket_of(h1, h2);
    const uint32_t* masks = tab + bucket * words;
    // one pass over the bucket: the prefix's members (itself included),
    // their maxima and whether one comes before this candidate
    uint32_t mine[kWords];
    float mx_pb = fmaxf(kNegInf, cpb), mx_pnb = fmaxf(kNegInf, cpnb);
    int others = 0, dup = 0;
    float o_pb = 0.f, o_pnb = 0.f;  // the other member's, where one
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      mine[k] = 0;
      if (k >= words || !is_cand) continue;
      for (uint32_t m = masks[k]; m != 0; m &= m - 1) {
        const int j = 32 * k + __ffs(m) - 1;
        if (j == cand) {
          mine[k] |= 1u << (j % 32);
          continue;
        }
        const uint32_t jh1 = c_h1[j], jh2 = c_h2[j];
        const float jpb = c_pb[j], jpnb = c_pnb[j];
        if (jh1 == h1 && jh2 == h2) {
          mine[k] |= 1u << (j % 32);
          mx_pb = fmaxf(mx_pb, jpb);
          mx_pnb = fmaxf(mx_pnb, jpnb);
          o_pb = jpb;
          o_pnb = jpnb;
          ++others;
          dup |= j < cand;
        }
      }
    }
    float mpb, mpnb;
    if (others == 0) {
      // the prefix's only candidate: the masked logsumexp of one term,
      // safe + logf(expf(x - safe)) with safe = x, is x + 0
      mpb = mx_pb <= kNegInf / 2 ? kNegInf : cpb + 0.f;
      mpnb = mx_pnb <= kNegInf / 2 ? kNegInf : cpnb + 0.f;
    } else {
      // the sums over the members, in the earlier kernel's order: partial
      // sums by j mod 4 in increasing j, combined as (s0 + s1) + (s2 + s3).
      // A member at the max adds expf(0) = 1 and one at NEG_INF adds
      // expf(<= NEG_INF / 2) = 0 (the max being above NEG_INF / 2); a sum
      // of 1 reads out as safe + logf(1) = safe + 0.
      const float safe_pb = fmaxf(mx_pb, kNegInf / 2);
      const float safe_pnb = fmaxf(mx_pnb, kNegInf / 2);
      const auto term = [](float x, float mx, float safe) {
        return x == mx ? 1.f : x == kNegInf ? 0.f : expf(x - safe);
      };
      float sum_pb, sum_pnb;
      if (others == 1) {
        // two members: whatever their lanes, the order above adds one
        // term to the other (and zeros)
        sum_pb = term(cpb, mx_pb, safe_pb) + term(o_pb, mx_pb, safe_pb);
        sum_pnb =
            term(cpnb, mx_pnb, safe_pnb) + term(o_pnb, mx_pnb, safe_pnb);
      } else {
        float spb[kLanes] = {0.f, 0.f, 0.f, 0.f};
        float spnb[kLanes] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          for (uint32_t m = mine[k]; m != 0; m &= m - 1) {
            const int j = 32 * k + __ffs(m) - 1;
            const float epb =
                term(j == cand ? cpb : c_pb[j], mx_pb, safe_pb);
            const float epnb =
                term(j == cand ? cpnb : c_pnb[j], mx_pnb, safe_pnb);
#pragma unroll
            for (int r = 0; r < kLanes; ++r) {
              if (j % kLanes == r) {
                spb[r] += epb;
                spnb[r] += epnb;
              }
            }
          }
        }
        sum_pb = (spb[0] + spb[1]) + (spb[2] + spb[3]);
        sum_pnb = (spnb[0] + spnb[1]) + (spnb[2] + spnb[3]);
      }
      mpb = mx_pb <= kNegInf / 2
                ? kNegInf
                : safe_pb + (sum_pb == 1.f ? 0.f : logf(sum_pb));
      mpnb = mx_pnb <= kNegInf / 2
                 ? kNegInf
                 : safe_pnb + (sum_pnb == 1.f ? 0.f : logf(sum_pnb));
    }
    // logaddexp(mpb, mpnb); where one side is NEG_INF and the other above
    // NEG_INF / 2, the log1pf term is log1pf(0) = 0, and where both are
    // NEG_INF it is lost to NEG_INF's rounding
    float full;
    if (mpb == kNegInf && mpnb == kNegInf)
      full = kNegInf;
    else if (mpb == kNegInf && mpnb > kNegInf / 2)
      full = mpnb + 0.f;
    else if (mpnb == kNegInf && mpb > kNegInf / 2)
      full = mpb + 0.f;
    else
      full = logaddexp(mpb, mpnb);
    const float tot = dup ? kNegInf : full;
    // rank key: the total's order, then the lower candidate index
    const unsigned long long key =
        (static_cast<unsigned long long>(order_key(tot)) << 32) |
        (0xffffffffu - static_cast<uint32_t>(cand));
    if (is_cand && q == 0) c_rk[my_pos] = key;
    __syncthreads();
    // the bucket is read; cleared for the next frame (each member its word)
    if (is_cand && q == 0) tab[bucket * words + cand / 32] = 0;
    // ---- top W by rank (lax.top_k's order); rank r becomes beam r ----
    int rank = 0;
    if (is_cand) {
      const ulonglong2* r2 =
          reinterpret_cast<const ulonglong2*>(c_rk + q * row);
      int ra = 0, rb = 0;  // two chains of adds, not one
#pragma unroll
      for (int c2 = 0; c2 < row / 2; ++c2) {
        const ulonglong2 v = r2[c2];
        ra += v.x > key;
        rb += v.y > key;
      }
      rank = ra + rb;
    }
    for (int off = 1; off < kLanes; off <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (is_cand && q == 0 && rank < W) {
      b_pb[rank] = mpb;
      b_pnb[rank] = mpnb;
      b_tot[rank] = full;
      b_h1[rank] = h1;
      b_h2[rank] = h2;
      b_len[rank] = clen;
      b_last[rank] = is_stay ? last : add;
      bp[(frame0 + t) * W + rank] =
          is_stay ? w
                  : (w | kExtBit | (plen >= L ? kCapBit : 0) |
                     static_cast<int>(static_cast<uint32_t>(add)
                                      << kAddShift));
    }
    // the inputs of frame t + kStages - 1, into the slot of frame t - 1
    const int tn = t + kStages - 1;
    if (tn < t_end) {
      const size_t f = frame0 + tn;
      stage_frame(ring + (tn % kStages) * sw, bars + tn % kStages,
                  lp + f * V, top_lp + f * K, top_ids + f * K, V, K,
                  bulk != 0);
    } else if (!bulk) {
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last frame's beams and back-pointers

  const size_t out = static_cast<size_t>(b) * W * L;
  for (int e = tid; e < W * L; e += blockDim.x) prefixes_out[out + e] = 0;
  int cur = tid, len = 0;
  bool wrote_last = false;
  if (tid < W) {
    len = b_len[tid];
    plen_out[b * W + tid] = len;
    pb_out[b * W + tid] = b_pb[tid];
    pnb_out[b * W + tid] = b_pnb[tid];
  }
  // ---- trace-back: each final beam walks its lineage from the last frame
  // (positions below L - 1 are written at most once along a lineage) ----
  const int cf = max(1, kBpChunk / W);
  for (int hi_t = t_end; hi_t > 0; hi_t -= cf) {
    const int lo_t = max(0, hi_t - cf);
    __syncthreads();  // the zeros, or the previous chunk's readers
    for (int e = tid; e < (hi_t - lo_t) * W; e += blockDim.x)
      bpc[e] = bp[(frame0 + lo_t) * W + e];
    __syncthreads();
    if (tid < W) {
      for (int t = hi_t - 1; t >= lo_t; --t) {
        const int e = bpc[(t - lo_t) * W + cur];
        if (e & kExtBit) {
          const int pos = len - 1;  // min(source length, L - 1)
          if (pos >= 0 && (pos < L - 1 || !wrote_last)) {
            prefixes_out[out + static_cast<size_t>(tid) * L + pos] =
                static_cast<int>(static_cast<uint32_t>(e) >> kAddShift);
            if (pos == L - 1) wrote_last = true;
          }
          len = (e & kCapBit) ? L : len - 1;
        }
        cur = min(e & kSrcMask, W - 1);
      }
    }
  }
}

}  // namespace

extern "C" {

// lp [B, T, V] f32, top_lp [B, T, K] f32, top_ids [B, T, K] int32 in
// [0, V), lens [B] int32, bp a [B, T, W] int32 scratch (the back-pointers)
// -> prefixes [B, W, L] int32, plen [B, W] int32, pb / pnb [B, W] f32.
// Takes W (K + 1) <= 256 candidates (one block), V < 2^23, and a block of
// at most 227 KB of shared memory (V up to ~14,000 at W = K = 8); other
// sizes return cudaErrorInvalidValue.
int asr_beam_search(const void* lp, const void* top_lp, const void* top_ids,
                    const void* lens, void* bp, void* prefixes, void* plen,
                    void* pb, void* pnb, int B, int T, int V, int W, int K,
                    int blank, int L, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (W <= 0 || K <= 0 || L <= 0 || V <= 0 || T < 0 || blank < 0 ||
      blank >= V || V >= (1 << (32 - kAddShift)) ||
      W * (K + 1) > kMaxCandidates)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(W, K, V).total;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // the served path's W = K = 8 has an instance of its own
  const auto kernel = W == 8 && K == 8 ? beam_search_kernel<8, 8>
                                       : beam_search_kernel<0, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int bulk = V % 4 == 0 && K % 4 == 0 && aligned(lp) &&
                   aligned(top_lp) && aligned(top_ids);
  const int threads = (kLanes * W * (K + 1) + 31) / 32 * 32;
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const float*>(top_lp),
      static_cast<const int*>(top_ids), static_cast<const int*>(lens),
      static_cast<int*>(bp), static_cast<int*>(prefixes),
      static_cast<int*>(plen), static_cast<float*>(pb),
      static_cast<float*>(pnb), T, V, W, K, blank, L, bulk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
