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
// 9.8 MB, ~2.9 us at 3.35 TB/s. The k rounds of compares (~k * V / 32 per
// lane) stay below that while the row lives in registers.
//
// Design: one warp per row, the row in registers (lane l holds elements
// l, l + 32, ...: coalesced 128-byte loads, 48 values a lane at V = 1536).
// Each round takes a lane-local max (strict > keeps the first index, since
// a lane's indices ascend) and then a warp shuffle argmax on (value, index)
// pairs, ties to the lower index; the owning lane masks its element.
// Lane r keeps the r-th pick, so the k outputs are written by k lanes at
// once. The TPU version's row tiles in VMEM and its lane padding are not
// carried over: the registers of one warp hold a row.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxK = 32;  // one pick per lane

template <int VPL>  // values per lane: V <= 32 * VPL
__global__ void topk_last_kernel(const float* __restrict__ x,
                                 float* __restrict__ vals,
                                 int* __restrict__ ids, int N, int V, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // whole warps leave together
  const float* xr = x + static_cast<size_t>(row) * V;
  float r[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int idx = j * 32 + lane;
    // padding sorts below every real entry (-inf ties go to the lower,
    // real index)
    r[j] = idx < V ? xr[idx] : -INFINITY;
  }
  float my_val = 0.f;
  int my_id = 0;
  for (int round = 0; round < k; ++round) {
    float best = r[0];
    int bj = 0;
#pragma unroll
    for (int j = 1; j < VPL; ++j) {
      if (r[j] > best) {
        best = r[j];
        bj = j;
      }
    }
    int bidx = bj * 32 + lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ov > best || (ov == best && oi < bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (lane == round) {
      my_val = best;
      my_id = bidx;
    }
    if ((bidx & 31) == lane) {
      const int jj = bidx >> 5;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (j == jj) r[j] = kNegInf;
      }
    }
  }
  if (lane < k) {
    vals[static_cast<size_t>(row) * k + lane] = my_val;
    ids[static_cast<size_t>(row) * k + lane] = my_id;
  }
}

template <int VPL>
cudaError_t launch(const float* x, float* vals, int* ids, int N, int V, int k,
                   cudaStream_t stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  topk_last_kernel<VPL><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      x, vals, ids, N, V, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, V] f32 -> vals [N, k] f32, ids [N, k] int32. Takes V <= 2048 (64
// values a lane) and k <= V, k <= 32; other sizes return
// cudaErrorInvalidValue.
int asr_topk_last(const void* x, void* vals, void* ids, int N, int V, int k,
                  void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || k <= 0 || k > V || k > kMaxK || V > 64 * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = (V + 31) / 32;
  cudaError_t rc;
  if (vpl <= 1) rc = launch<1>(xp, vp, ip, N, V, k, s);
  else if (vpl <= 2) rc = launch<2>(xp, vp, ip, N, V, k, s);
  else if (vpl <= 4) rc = launch<4>(xp, vp, ip, N, V, k, s);
  else if (vpl <= 8) rc = launch<8>(xp, vp, ip, N, V, k, s);
  else if (vpl <= 16) rc = launch<16>(xp, vp, ip, N, V, k, s);
  else if (vpl <= 32) rc = launch<32>(xp, vp, ip, N, V, k, s);
  else if (vpl <= 48) rc = launch<48>(xp, vp, ip, N, V, k, s);
  else rc = launch<64>(xp, vp, ip, N, V, k, s);
  return static_cast<int>(rc);
}

}  // extern "C"
