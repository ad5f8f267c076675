// Exact top-k over the last axis for the PyTorch port (the beam search's
// per-frame symbol pre-prune).
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/topk_kernel.py:topk_last
// (_topk_kernel): k rounds of (max, first index attaining it, mask that
// index to exactly -1e30) over each row of x [N, V] f32, giving values
// descending with ties to the lower index, as lax.top_k orders them. A row
// with fewer than k entries above -1e30 degrades as the JAX kernel does
// (the masked pick is found again). Pure f32 compares, no arithmetic, so
// the kernel and its twin (kernels/topk.py) agree bit for bit.
//
// Bound: bytes. Each row is read once (V = 1536 f32 = 6 KB); the output is
// k floats and k ints. At the beam path's N = B * T = 1600 rows that is
// 9.8 MB, ~2.9 us at 3.35 TB/s.
//
// Design: one warp per row, the row in registers. Lane l holds elements
// 128 g + 4 l + c (c = 0 .. 3) of each group g, read by 16-byte loads
// where the row is 16-byte aligned (else by 4-byte loads in the same
// layout), G groups a lane (V <= 128 G; 12 at V = 1536). Each lane keeps
// the best (value, slot) of each of its groups and of all its groups,
// each a tree in which the right side (higher indices) wins only on a
// strictly larger value. A round takes the warp's max of one 32-bit key a
// lane (the value's order-preserving bits, -0 as +0, so that 0.0 and -0.0
// compare equal as in the JAX kernel) and then the least index among the
// lanes at that key, each by one warp reduction; only the lane that owns
// the pick writes it, masks the element to -1e30 and rescans that one
// group and its groups' tree: the other lanes keep their best. Padding past
// V reads -inf, below every real entry (ties go to the lower, real index).
// The TPU version's row tiles in VMEM and its lane padding are not carried
// over: the registers of one warp hold a row.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxK = 32;
constexpr int kMaxGroups = 16;  // V <= 2048
constexpr unsigned kAll = 0xffffffffu;

struct Best {
  float v;
  int slot;  // 4 g + c within the lane
};

// b only where strictly larger: a holds the lower indices
__device__ __forceinline__ Best pick(Best a, Best b) {
  return b.v > a.v ? b : a;
}

__device__ __forceinline__ Best group_best(float4 q, int g) {
  return pick(pick({q.x, 4 * g}, {q.y, 4 * g + 1}),
              pick({q.z, 4 * g + 2}, {q.w, 4 * g + 3}));
}

// the best of groups Lo .. Hi - 1, a tree of depth ceil(log2(Hi - Lo))
template <int Lo, int Hi, int G>
__device__ __forceinline__ Best tree(const Best (&gb)[G]) {
  if constexpr (Hi - Lo == 1) {
    return gb[Lo];
  } else {
    constexpr int Mid = (Lo + Hi + 1) / 2;
    return pick(tree<Lo, Mid>(gb), tree<Mid, Hi>(gb));
  }
}

// mask component c of group g (Lo <= g < Hi) to -1e30 and take its best
// again: a binary search over the groups, whose registers are named
// statically
template <int Lo, int Hi, int G>
__device__ __forceinline__ void rescan(float4 (&r)[G], Best (&gb)[G], int g,
                                       int c) {
  if constexpr (Hi - Lo == 1) {
    float4& q = r[Lo];
    q.x = c == 0 ? kNegInf : q.x;
    q.y = c == 1 ? kNegInf : q.y;
    q.z = c == 2 ? kNegInf : q.z;
    q.w = c == 3 ? kNegInf : q.w;
    gb[Lo] = group_best(q, Lo);
  } else {
    constexpr int Mid = (Lo + Hi) / 2;
    if (g < Mid) {
      rescan<Lo, Mid>(r, gb, g, c);
    } else {
      rescan<Mid, Hi>(r, gb, g, c);
    }
  }
}

// the float's order as an unsigned key, -0 folded onto +0
__device__ __forceinline__ unsigned ordered(float v) {
  unsigned u = __float_as_uint(v);
  u = u == 0x80000000u ? 0u : u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int G>  // groups a lane: V <= 128 * G
__global__ void __launch_bounds__(128)
topk_last_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ ids, int N, int V, int k, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const float* xr = x + static_cast<size_t>(row) * V;
  float4 r[G];
  if (vec) {  // 16-byte aligned rows: V % 4 == 0, whole groups in or out
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int idx = 128 * g + 4 * lane;
      r[g] = idx < V ? __ldg(reinterpret_cast<const float4*>(xr + idx))
                     : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                   -INFINITY);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int idx = 128 * g + 4 * lane;
      r[g].x = idx < V ? xr[idx] : -INFINITY;
      r[g].y = idx + 1 < V ? xr[idx + 1] : -INFINITY;
      r[g].z = idx + 2 < V ? xr[idx + 2] : -INFINITY;
      r[g].w = idx + 3 < V ? xr[idx + 3] : -INFINITY;
    }
  }
  Best gb[G];
#pragma unroll
  for (int g = 0; g < G; ++g) gb[g] = group_best(r[g], g);
  Best best = tree<0, G>(gb);
  float* vr = vals + static_cast<size_t>(row) * k;
  int* ir = ids + static_cast<size_t>(row) * k;
  for (int round = 0; round < k; ++round) {
    const unsigned key = ordered(best.v);
    const unsigned top = __reduce_max_sync(kAll, key);
    const int g = best.slot >> 2, c = best.slot & 3;
    const unsigned idx = 128 * g + 4 * lane + c;
    const unsigned at = __reduce_min_sync(kAll, key == top ? idx : ~0u);
    if (idx == at) {  // the lane that owns the pick
      vr[round] = best.v;
      ir[round] = static_cast<int>(at);
      rescan<0, G>(r, gb, g, c);
      best = tree<0, G>(gb);
    }
  }
}

constexpr int kWarpsPerBlock = 4;

template <int G>
cudaError_t launch(const float* x, float* vals, int* ids, int N, int V, int k,
                   cudaStream_t stream) {
  const int vec = V % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  topk_last_kernel<G><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      x, vals, ids, N, V, k, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, V] f32 -> vals [N, k] f32, ids [N, k] int32. Takes V <= 2048 (16
// groups of 128 a lane) and k <= V, k <= 32; other sizes return
// cudaErrorInvalidValue.
int asr_topk_last(const void* x, void* vals, void* ids, int N, int V, int k,
                  void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || k <= 0 || k > V || k > kMaxK || V > 128 * kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (V + 127) / 128;
  cudaError_t rc;
  if (groups <= 1) rc = launch<1>(xp, vp, ip, N, V, k, s);
  else if (groups <= 2) rc = launch<2>(xp, vp, ip, N, V, k, s);
  else if (groups <= 4) rc = launch<4>(xp, vp, ip, N, V, k, s);
  else if (groups <= 8) rc = launch<8>(xp, vp, ip, N, V, k, s);
  else if (groups <= 12) rc = launch<12>(xp, vp, ip, N, V, k, s);
  else rc = launch<16>(xp, vp, ip, N, V, k, s);
  return static_cast<int>(rc);
}

}  // extern "C"
