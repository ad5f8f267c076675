// Fused position-wise feed-forward block for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/ffn_kernel.py fused_ffn
// (_fused_ffn, its pallas_call and the body _ffn_kernel). It computes, in
// the input type T (bfloat16 or float32):
//
//   inner = relu(T(T(x . W1^T, f32 accumulation) + b1))
//   y     = T(T(inner . W2^T, f32 accumulation) + b2)
//
// with x [N, D], W1 [F, D], b1 [F], W2 [D, F], b2 [D] (the port's Linear
// layout, the transpose of JAX's): each inner element is one f32 sum over
// the whole of D, rounded to T, the bias added in T (an f32 add rounded
// once), as flax's Dense and the port's Dense round. The [N, F] inner
// activation never goes to device memory. The backward is plain PyTorch
// (kernels/ffn.py), as the JAX VJP is plain XLA.
//
// Bound: at the LM's training shape (N 4096, D 512, F 2048, bf16) the
// function is 17.2 GFLOP against 12.6 MB of inputs and outputs, so it is
// bound by the tensor cores (17.4 us at 989 TFLOP/s). On the TPU both
// weights sat in VMEM (10 MB); here each is 2 MB in bf16 against 227 KB
// of shared memory a block, so the weights stream through shared memory.
// The earlier kernel gave a block 32 rows and all of F, so one block's
// chain of 32 inner chunks set its time at every N (0.18 ms; one block on
// one SM at a decode step's N 8).
//
// bf16 (ffn_bf16_kernel): the inner width is split across blocks as well
// as the rows. A block owns 128 rows of x and one F-slice of at most 256
// inner columns; the slices of a row tile are the blocks of one thread
// block cluster (8 where F allows; plan() below, mirrored by
// kernels/ffn.py plan), so every N fills the card, N 8 included (one
// cluster of eight blocks). Two warpgroups, each 64 rows.
//   Phase 1: the inner slice [128, width], one f32 sum over all of D a
//   element: x and W1 stream in k-tiles of 64 columns (TMA boxes of 128
//   and `width` rows, 128-byte swizzle) through a ring of three stages
//   with an mbarrier each (one block barrier a tile); wgmma m64n256k16
//   with both operands in shared memory, 128 f32 accumulators a thread.
//   b1, relu and the rounding, then the slice stays in shared memory as
//   the next product's A operand (swizzled as TMA would write it; each
//   inner element is computed once).
//   Phase 2: for each group of 256 output columns (the accumulators'
//   registers force the groups), the partial [128, group] = inner slice .
//   W2[group, slice]^T, W2 streamed through the same ring, wgmma again.
//   Reduction: each block writes its f32 partial into its own shared
//   memory (over the ring), cluster.sync(), then block r sums rows 16r..
//   (for eight slices) of every block's partial in rank order through
//   distributed shared memory, adds b2, rounds and stores; a second
//   cluster.sync() keeps each partial alive until its readers are done.
//   No atomics and no workspace: the result is the same from launch to
//   launch. Where F exceeds 8 slices of 256, the launcher makes passes over
//   F, each a launch of the same kernel over 8 x 256 more inner columns,
//   the running f32 sum in a workspace [N, D] (summed in pass order; the
//   last pass adds b2 and rounds).
//   What bounds it on the card: at N 4096 the 256 blocks do not fit in
//   one wave (a cluster of eight needs eight free SMs of one GPC), and a
//   block spends about as long moving its partials through distributed
//   shared memory, whose rate is far below shared memory's, as on its
//   products (PERF.md). The first versions of this design, on mma.sync
//   with 16-byte cp.async copies, were slower at every N.
// f32 (ffn_f32_kernel, ffn_f32_wide_kernel): plain FMAs, never TF32, so
// that it matches the f32 twin; 32 rows a block, all of F in chunks of 32,
// staged synchronously; D above 512 in column groups of 512 with the first
// product's slices of D staged in turn.
//
// Limits (kernels/ffn.py pads D and F to multiples of 16 with zeros, which
// is exact): D and F multiples of 16, D >= 16, F >= 16, any N >= 1.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;      // f32: rows of x a block
constexpr int kMaxD = 512;     // widest output column group
constexpr int kChunkF32 = 32;  // f32: inner columns a chunk (one a lane)
constexpr int kMaxSmem = 232448;
// bf16
constexpr int kBRows = 128;      // rows of x a block
constexpr int kKT = 64;          // columns of a k-tile: one 128-byte row
constexpr int kStages = 3;       // k-tiles in the ring
constexpr int kMaxSlice = 256;   // inner columns a block
constexpr int kGroup = 256;      // output columns a group
constexpr int kMaxCluster = 8;   // F-slices a row tile
constexpr int kAlignSlack = 2048;  // mbarriers + the region's alignment

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// torch.relu: a NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// ------------------------------------------------------------------- f32

// Shared layout, in this order: x [32][D], a W1 chunk [32][D + 1], the
// W2 chunk transposed [32][D + 1] (chunk column f, output column n) and
// the inner chunk [32][32], all f32.
struct F32Layout {
  size_t x, w1, w2, inner, total;
  __host__ __device__ explicit F32Layout(int d) {
    const size_t prow = static_cast<size_t>(d + 1) * 4;
    x = 0;
    w1 = x + round16(static_cast<size_t>(kRows) * d * 4);
    w2 = w1 + round16(kChunkF32 * prow);
    inner = w2 + round16(kChunkF32 * prow);
    total = inner + round16(kRows * kChunkF32 * 4);
  }
};

__global__ void __launch_bounds__(kThreads)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ y, int N,
               int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Layout lay(D);
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  float* w1s = reinterpret_cast<float*>(smem + lay.w1);
  float* w2t = reinterpret_cast<float*>(smem + lay.w2);
  float* ins = reinterpret_cast<float*>(smem + lay.inner);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows;
  const int valid = min(kRows, N - row0);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    xs[i] = r < valid ? x[static_cast<size_t>(row0) * D + i] : 0.f;
  }

  // warp w owns rows 4w..4w+3; lane l the output columns l, l + 32, ...
  constexpr int kR = kRows / kWarps;
  constexpr int kCols = kMaxD / 32;
  float acc[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunkF32) {
    const int fc = min(kChunkF32, F - f0);
    __syncthreads();  // the previous chunk is read by every warp
    for (int i = threadIdx.x; i < fc * D; i += kThreads) {
      const int f = i / D;
      const int c = i - f * D;
      w1s[f * (D + 1) + c] = w1[static_cast<size_t>(f0) * D + i];
    }
    for (int i = threadIdx.x; i < D * fc; i += kThreads) {
      const int n = i / fc;
      const int f = i - n * fc;
      w2t[f * (D + 1) + n] = w2[static_cast<size_t>(n) * F + f0 + f];
    }
    __syncthreads();

    // inner chunk: lane l is column f0 + l of the warp's four rows
    if (lane < fc) {
      float c[kR] = {0.f, 0.f, 0.f, 0.f};
      const float* wr = w1s + lane * (D + 1);
      for (int d = 0; d < D; ++d) {
        const float w = wr[d];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          c[r] = fmaf(xs[(warp * kR + r) * D + d], w, c[r]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        ins[(warp * kR + r) * kChunkF32 + lane] = relu(c[r] + b1[f0 + lane]);
    }
    __syncwarp();  // a warp reads only its own rows of the inner chunk

    for (int f = 0; f < fc; ++f) {
      const float* wc = w2t + f * (D + 1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if (col < D) {
          const float w = wc[col];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[r][j] = fmaf(ins[(warp * kR + r) * kChunkF32 + f], w,
                             acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = warp * kR + r;
    if (row >= valid) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = lane + 32 * j;
      if (col < D)
        y[static_cast<size_t>(row0 + row) * D + col] = acc[r][j] + b2[col];
    }
  }
}

// D > kMaxD: block (i, j) takes rows 32i.. and output columns 512j.. . The
// shared layout is the narrow kernel's at D = 512: an x slice [32][512], a
// W1 chunk slice [32][512 + 1], the group's W2 chunk transposed
// [32][512 + 1] and the inner chunk [32][32].
__global__ void __launch_bounds__(kThreads)
ffn_f32_wide_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ y,
                    int N, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Layout lay(kMaxD);
  constexpr int ld = kMaxD + 1;
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  float* w1s = reinterpret_cast<float*>(smem + lay.w1);
  float* w2t = reinterpret_cast<float*>(smem + lay.w2);
  float* ins = reinterpret_cast<float*>(smem + lay.inner);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows;
  const int valid = min(kRows, N - row0);
  const int c0 = blockIdx.y * kMaxD;
  const int dc = min(kMaxD, D - c0);

  constexpr int kR = kRows / kWarps;
  constexpr int kCols = kMaxD / 32;
  float acc[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunkF32) {
    const int fc = min(kChunkF32, F - f0);
    float c[kR] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D; k0 += kMaxD) {
      const int kc = min(kMaxD, D - k0);
      __syncthreads();  // the previous slice and chunk are read by every warp
      for (int i = threadIdx.x; i < kRows * kc; i += kThreads) {
        const int r = i / kc;
        const int d = i - r * kc;
        xs[r * kMaxD + d] =
            r < valid ? x[static_cast<size_t>(row0 + r) * D + k0 + d] : 0.f;
      }
      for (int i = threadIdx.x; i < fc * kc; i += kThreads) {
        const int f = i / kc;
        const int d = i - f * kc;
        w1s[f * ld + d] = w1[static_cast<size_t>(f0 + f) * D + k0 + d];
      }
      __syncthreads();
      if (lane < fc) {
        const float* wr = w1s + lane * ld;
        for (int d = 0; d < kc; ++d) {
          const float w = wr[d];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            c[r] = fmaf(xs[(warp * kR + r) * kMaxD + d], w, c[r]);
        }
      }
    }
    if (lane < fc) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        ins[(warp * kR + r) * kChunkF32 + lane] = relu(c[r] + b1[f0 + lane]);
    }
    for (int i = threadIdx.x; i < dc * fc; i += kThreads) {
      const int n = i / fc;
      const int f = i - n * fc;
      w2t[f * ld + n] = w2[static_cast<size_t>(c0 + n) * F + f0 + f];
    }
    __syncthreads();  // the W2 chunk is staged by every warp

    for (int f = 0; f < fc; ++f) {
      const float* wc = w2t + f * ld;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if (col < dc) {
          const float w = wc[col];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[r][j] = fmaf(ins[(warp * kR + r) * kChunkF32 + f], w,
                             acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = warp * kR + r;
    if (row >= valid) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = lane + 32 * j;
      if (col < dc)
        y[static_cast<size_t>(row0 + row) * D + c0 + col] =
            acc[r][j] + b2[c0 + col];
    }
  }
}


// ------------------------------------------------------------------ bf16

// The bf16 kernel's tiling for x [N, D], F inner columns.
struct Plan {
  int rows;         // rows of x a block
  int slices;       // F-slices a row tile: the blocks of one cluster
  int width;        // inner columns a slice (a multiple of 16, <= 256)
  int passes;       // launches, each over slices * width inner columns
  int groups;       // output column groups of 256
  size_t smem;      // dynamic shared memory a block
  size_t workspace;  // bytes of the f32 running sum (passes > 1)
};

// Shared layout: three mbarriers; then, 1024-byte aligned as the 128-byte
// swizzle needs, one region that holds in turn the ring of kStages k-tiles
// (phase 1: x [128][64] and W1 [256][64]; phase 2: W2 [256][64]; rows of
// 128 bytes, swizzled) and the f32 partial [128][group + 8]; the inner
// slice in atoms of [128][64] bf16 (swizzled, the A operand of phase 2);
// b1's slice.
constexpr size_t kStage = (kBRows + kMaxSlice) * 128;
constexpr size_t kAtom = kBRows * 128;
__host__ __device__ inline size_t bf16_smem(int width) {
  return kAlignSlack + kStages * kStage + (width + kKT - 1) / kKT * kAtom +
         kMaxSlice * 2;
}

Plan make_plan(int n, int d, int f) {
  Plan p;
  p.rows = kBRows;
  int s = kMaxCluster;
  while (s > f / 16) s /= 2;  // at least 16 inner columns a slice
  p.slices = s;
  const int cap = f < s * kMaxSlice ? f : s * kMaxSlice;
  p.width = ((cap + s - 1) / s + 15) / 16 * 16;
  p.passes = (f + s * p.width - 1) / (s * p.width);
  p.groups = (d + kGroup - 1) / kGroup;
  p.smem = bf16_smem(p.width);
  p.workspace = p.passes > 1 ? static_cast<size_t>(n) * d * 4 : 0;
  return p;
}

// T(T(a) + bias.x), T(T(b) + bias.y) as floats: the product rounded to
// bf16, then the bias added, rounded
__device__ __forceinline__ float2 bf16_add2(float a, float b, float2 bias) {
  const float2 t = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  return __bfloat1622float2(
      __floats2bfloat162_rn(t.x + bias.x, t.y + bias.y));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// The box of a 2-D tensor map at (column c, row r) into shared memory at
// dst, completing on the mbarrier bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: K-major rows of 128 bytes with the
// 128-byte swizzle, 8-row groups 1024 bytes apart, starting at addr.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// d[0..127] (+)= A . B^T on the tensor cores for one warpgroup: A 64 rows x
// 16 (k) and B 256 rows x 16 (k), both bf16 in shared memory, K-major with
// the 128-byte swizzle (descriptors a, b); d in the m64n256 accumulator
// layout (thread l of warp w: rows 16w + l / 4 (+ 8), columns 8j + 2 (l %
// 4) (+ 1) in d[4j..4j + 3]).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  // scale-d p = 1: d += A . B^T
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Commits the warpgroup's wgmma and waits for them.
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Block (slice s, row tile i) of the cluster of row tile i: rows 128 i..,
// inner columns f_begin + s * width.. of this pass. `first` / `last`: the
// pass reads / writes the workspace or writes y. Warpgroup h (warps 4h..)
// takes rows 64 h.. and, with m64n256k16 wgmma, all 256 columns of the
// slice in phase 1 and of the column group in phase 2: 128 f32
// accumulators a thread in each.
__global__ void __launch_bounds__(kThreads, 1)
ffn_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tw2,
                const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                bf16* __restrict__ y, float* __restrict__ ws, int N, int D,
                int F, int width, int f_begin, int first, int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int slice = static_cast<int>(cluster.block_rank());
  const uint32_t bars = smem_u32(smem);
  const uint32_t region = (bars + kAlignSlack - 1024 + 1023) & ~1023u;
  unsigned char* region_p = smem + (region - bars);
  const uint32_t inner = region + kStages * kStage;
  bf16* b1s = reinterpret_cast<bf16*>(
      region_p + kStages * kStage + (width + kKT - 1) / kKT * kAtom);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp >> 2;                            // warpgroup
  const int r0 = 64 * h + 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const int c2 = 2 * (lane & 3);                       // columns 8j + c2, + 1
  const int row0 = static_cast<int>(blockIdx.x) / S * kBRows;
  const int valid = min(kBRows, N - row0);
  const int f0 = f_begin + slice * width;     // the slice's first column
  const int fc = max(0, min(width, F - f0));  // its width, 0 past F
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < fc; c += kThreads) b1s[c] = b1[f0 + c];
  __syncthreads();
  auto slot = [&](int s) { return region + s * static_cast<uint32_t>(kStage); };

  // Runs k-tiles 0..n-1 through the ring: issue(t, s, bar), by one thread,
  // starts tile t's boxes into slot s and returns their bytes; compute(t,
  // s) runs the warpgroup's wgmma on it. Two tiles are in flight while one
  // is computed; one barrier a tile frees the slot the next issue
  // overwrites. `seq` counts the tiles of every pass through the ring,
  // which sets each slot's phase.
  int seq = 0;
  auto pipeline = [&](int n, auto issue, auto compute) {
    auto start = [&](int t) {
      const int s = (seq + t) % kStages;
      const uint32_t bar = bars + 8 * s;
      mbar_expect(bar, issue(t, slot(s), bar));
    };
    if (threadIdx.x == 0)
      for (int t = 0; t < kStages - 1 && t < n; ++t) start(t);
    for (int t = 0; t < n; ++t) {
      const int q = seq + t;
      mbar_wait(bars + 8 * (q % kStages), (q / kStages) & 1);
      __syncthreads();
      if (threadIdx.x == 0 && t + kStages - 1 < n) start(t + kStages - 1);
      compute(t, slot(q % kStages));
    }
    seq += n;
    __syncthreads();
  };
  float d[128];

  // phase 1: the inner slice
  if (fc > 0) {
#pragma unroll
    for (int k = 0; k < 128; ++k) d[k] = 0.f;
    auto issue = [&](int t, uint32_t dst, uint32_t bar) {
      tma_box(dst, &tx, t * kKT, row0, bar);
      tma_box(dst + kAtom, &tw1, t * kKT, f0, bar);
      return static_cast<uint32_t>(kBRows + width) * 128;
    };
    auto compute = [&](int t, uint32_t xs) {
      const int kc = min(kKT, D - t * kKT);
      wgmma_fence();
      for (int kk = 0; kk < kc; kk += 16)
        wgmma_256(d, smem_desc(xs + h * (kAtom / 2) + kk * 2),
                  smem_desc(xs + kAtom + kk * 2));
      wgmma_commit_wait();
    };
    pipeline((D + kKT - 1) / kKT, issue, compute);
    // b1, relu, rounded: the slice in shared memory, swizzled as TMA would
    // write it (two columns at a time)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + c2;
      if (col >= fc) break;
      const float2 bias = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1s + col));
      const uint32_t atom = inner + (col / kKT) * kAtom + c2 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const float2 v = bf16_add2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1],
                                   bias);
        const __nv_bfloat162 o = __floats2bfloat162_rn(relu(v.x), relu(v.y));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         atom + r * 128 + (((j & 7) ^ (r & 7)) << 4)),
                     "r"(*reinterpret_cast<const uint32_t*>(&o)));
      }
    }
    // the slice's generic writes before wgmma reads them (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // phase 2, a column group at a time
  for (int c0 = 0; c0 < D; c0 += kGroup) {
    const int dg = min(kGroup, D - c0);
#pragma unroll
    for (int k = 0; k < 128; ++k) d[k] = 0.f;
    if (fc > 0) {
      auto issue = [&](int t, uint32_t dst, uint32_t bar) {
        tma_box(dst, &tw2, f0 + t * kKT, c0, bar);
        return static_cast<uint32_t>(min(D, kGroup)) * 128;
      };
      auto compute = [&](int t, uint32_t w2s) {
        const int kc = min(kKT, fc - t * kKT);
        const uint32_t a = inner + t * kAtom + h * (kAtom / 2);
        wgmma_fence();
        for (int kk = 0; kk < kc; kk += 16)
          wgmma_256(d, smem_desc(a + kk * 2), smem_desc(w2s + kk * 2));
        wgmma_commit_wait();
      };
      pipeline((fc + kKT - 1) / kKT, issue, compute);
    }
    // the block's f32 partial over the ring
    float* part = reinterpret_cast<float*>(region_p);
    const int pld = dg + 8;  // half-warps' float2 stores in distinct banks
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + c2;
      if (col >= dg) break;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(part + (r0 + 8 * half) * pld + col) =
            make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
    cluster.sync();
    // block `slice` sums rows slice * 128 / S.. of every partial in rank
    // order (the peers' loads issued together)
    const int share = kBRows / S;
    const int quads = dg / 4;
    for (int i = threadIdx.x; i < share * quads; i += kThreads) {
      const int r = slice * share + i / quads;
      const int col = (i % quads) * 4;
      if (r >= valid) continue;
      float4 v[kMaxCluster];
#pragma unroll
      for (int peer = 0; peer < kMaxCluster; ++peer)
        if (peer < S)
          v[peer] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, peer) + r * pld + col);
      float4 sum = v[0];
#pragma unroll
      for (int peer = 1; peer < kMaxCluster; ++peer)
        if (peer < S) {
          sum.x += v[peer].x;
          sum.y += v[peer].y;
          sum.z += v[peer].z;
          sum.w += v[peer].w;
        }
      const size_t o = static_cast<size_t>(row0 + r) * D + c0 + col;
      if (!first) {
        const float4 w = *reinterpret_cast<const float4*>(ws + o);
        sum.x += w.x;
        sum.y += w.y;
        sum.z += w.z;
        sum.w += w.w;
      }
      if (!last) {
        *reinterpret_cast<float4*>(ws + o) = sum;
        continue;
      }
      const __nv_bfloat162* bias =
          reinterpret_cast<const __nv_bfloat162*>(b2 + c0 + col);
      const float2 lo = bf16_add2(sum.x, sum.y, __bfloat1622float2(bias[0]));
      const float2 hi = bf16_add2(sum.z, sum.w, __bfloat1622float2(bias[1]));
      __nv_bfloat162 out[2];
      out[0] = __floats2bfloat162_rn(lo.x, lo.y);
      out[1] = __floats2bfloat162_rn(hi.x, hi.y);
      *reinterpret_cast<uint2*>(y + o) = *reinterpret_cast<const uint2*>(out);
    }
    // every partial is read before the ring is written again (TMA)
    asm volatile("fence.proxy.async;\n" ::: "memory");
    cluster.sync();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a row-major bf16 [rows][cols] matrix in boxes of box_rows rows
// x 64 columns with the 128-byte swizzle; what falls outside reads as zero.
bool box_map(CUtensorMap* map, const void* base, int rows, int cols,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kKT, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* y, void* workspace, int N, int D, int F,
                cudaStream_t stream) {
  const Plan p = make_plan(N, D, F);
  if (p.workspace > 0 && workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw1, tw2;
  if (!box_map(&tx, x, N, D, kBRows) || !box_map(&tw1, w1, F, D, p.width) ||
      !box_map(&tw2, w2, D, F, D < kGroup ? D : kGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ffn_bf16_kernel, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + p.rows - 1) / p.rows * p.slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int pass = 0; pass < p.passes; ++pass) {
    err = cudaLaunchKernelEx(
        &cfg, ffn_bf16_kernel, tx, tw1, tw2, static_cast<const bf16*>(b1),
        static_cast<const bf16*>(b2), static_cast<bf16*>(y),
        static_cast<float*>(workspace), N, D, F, p.width,
        pass * p.slices * p.width, static_cast<int>(pass == 0),
        static_cast<int>(pass == p.passes - 1));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, int N, int D, int F,
               cudaStream_t stream) {
  const bool wide = D > kMaxD;
  const dim3 grid((N + kRows - 1) / kRows, wide ? (D + kMaxD - 1) / kMaxD : 1);
  const size_t smem = F32Layout(wide ? kMaxD : D).total;
  auto kernel = wide ? ffn_f32_wide_kernel : ffn_f32_kernel;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), N, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One field of the tiling the launcher uses for dtype_code (0: float32, 1:
// bfloat16) at x [n, d] and f inner columns: 0 rows a block, 1 F-slices a
// row tile (the cluster's size), 2 inner columns a slice, 3 passes, 4
// output column groups, 5 dynamic shared memory a block, 6 workspace bytes;
// -1 for an unknown field. kernels/ffn.py plan mirrors it.
long long asr_fused_ffn_plan(int dtype_code, int n, int d, int f,
                             int field) {
  if (dtype_code == 1) {
    const Plan p = make_plan(n, d, f);
    const long long v[] = {p.rows, p.slices, p.width, p.passes, p.groups,
                           static_cast<long long>(p.smem),
                           static_cast<long long>(p.workspace)};
    return field >= 0 && field < 7 ? v[field] : -1;
  }
  const long long v[] = {kRows, 1, f, 1, (d + kMaxD - 1) / kMaxD,
                         static_cast<long long>(
                             F32Layout(d < kMaxD ? d : kMaxD).total),
                         0};
  return field >= 0 && field < 7 ? v[field] : -1;
}

// dtype_code 0: float32, 1: bfloat16. x [N, D], w1 [F, D], b1 [F], w2 [D, F],
// b2 [D] -> y [N, D], all of that type and contiguous, bf16 pointers
// 16-byte aligned; workspace: f32 of the plan's workspace bytes (16-byte
// aligned), null where the plan needs none. Sizes outside the limits above
// are refused with cudaErrorInvalidValue before anything is launched.
int asr_fused_ffn(int dtype_code, const void* x, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* y,
                  void* workspace, int N, int D, int F, void* stream) {
  if (D < 16 || D % 16 != 0 || F < 16 || F % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch_bf16(x, w1, b1, w2, b2, y, workspace, N, D, F, s);
  if (dtype_code == 0) return launch_f32(x, w1, b1, w2, b2, y, N, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
