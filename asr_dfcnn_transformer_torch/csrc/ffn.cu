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
// layout, the transpose of JAX's): each product is accumulated in f32 and
// rounded to T, the bias is added in T (an f32 add rounded once), as
// flax's Dense and the port's Dense round. The [N, F] inner activation
// never goes to device memory: one block takes 32 rows of x, walks F in
// chunks, forms each [32, Fc] inner chunk in shared memory and adds its
// product with the matching W2 columns into a [32, D] f32 accumulator held
// in registers. The backward is plain PyTorch (kernels/ffn.py), as the JAX
// VJP is plain XLA.
//
// Bound: at the LM's training shape (N 4096, D 512, F 2048, bf16) the
// function is 17.2 GFLOP against 12.6 MB of inputs and outputs, so it is
// bound by the tensor cores (0.0174 ms at 989 TFLOP/s). On the TPU both
// weights sat in VMEM (10 MB); here each is 2 MB in bf16 against 227 KB of
// shared memory a block, so every block streams both weights through
// shared memory once (from L2 after the first block). bf16 runs mma.sync
// m16n8k16 tensor-core tiles with f32 accumulation; f32 runs plain FMAs,
// never TF32, so that it matches the f32 twin. Rows are padded by 16 bytes
// so that a fragment's eight rows fall in different banks. In bf16 the
// weights are staged with cp.async, one buffer each: the next W1 chunk
// loads while the W2 product runs, the next W2 chunk while the next W1
// product runs. Every block still reads both weights whole (4 MB from L2
// at N 4096 x 128 blocks: 512 MB), which bounds it above the tensor cores;
// larger row tiles, wgmma and TMA are later work. The f32 kernel stages
// synchronously.
//
// Widths above kMaxD (512) take the wide kernels: a second grid dimension
// splits the output columns into groups of 512, each block keeping its
// group's [32, 512] f32 accumulator in registers, and the first product
// walks D in slices of 512 staged in turn (x and W1 read again from L2 for
// each inner chunk and column group, and each block recomputes its inner
// chunks, which is exact). The slices and chunks run in the same order as
// the narrow kernels' loops, so the arithmetic is theirs. The wide kernels
// stage synchronously.
//
// Limits (kernels/ffn.py pads D and F to multiples of 16 with zeros, which
// is exact): D and F multiples of 16, D >= 16, F >= 16, any N >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;      // rows of x a block
constexpr int kMaxD = 512;     // narrow kernels' widest D; wide: slice, group
constexpr int kChunkBf16 = 64;  // inner columns a chunk, bf16
constexpr int kChunkF32 = 32;   // inner columns a chunk, f32 (one a lane)
constexpr int kPadBf16 = 8;     // 16 bytes of row padding
constexpr int kMaxSmem = 232448;

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// torch.relu: a NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// ------------------------------------------------------------------ bf16

// Shared layout, in this order: x [32][D + 8], a W1 chunk [64][D + 8], a W2
// chunk [D][64 + 8] and the inner chunk [32][64 + 8], all bf16.
struct Bf16Layout {
  size_t x, w1, w2, inner, total;
  __host__ __device__ explicit Bf16Layout(int d) {
    const size_t row = static_cast<size_t>(d + kPadBf16) * 2;
    const size_t crow = static_cast<size_t>(kChunkBf16 + kPadBf16) * 2;
    x = 0;
    w1 = x + round16(kRows * row);
    w2 = w1 + round16(kChunkBf16 * row);
    inner = w2 + round16(static_cast<size_t>(d) * crow);
    total = inner + round16(kRows * crow);
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a row-major [16][16] tile at `tile` (row stride `ld`
// elements): rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile,
                                       int ld, int g, int t) {
  a[0] = ld32(tile + g * ld + 2 * t);
  a[1] = ld32(tile + (g + 8) * ld + 2 * t);
  a[2] = ld32(tile + g * ld + 2 * t + 8);
  a[3] = ld32(tile + (g + 8) * ld + 2 * t + 8);
}

// A fragment of the [16 k][8 n] operand B[k][n] = W[n][k], W row-major at
// `w` (row stride `ld`): row g of W, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* w,
                                       int ld, int g, int t) {
  b[0] = ld32(w + g * ld + 2 * t);
  b[1] = ld32(w + g * ld + 2 * t + 8);
}

__device__ __forceinline__ float bf16_add(float a, __nv_bfloat16 b) {
  // T(T(a) + b): the product rounded to bf16, then the bias added, rounded
  return __bfloat162float(__float2bfloat16_rn(
      __bfloat162float(__float2bfloat16_rn(a)) + __bfloat162float(b)));
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async); with `valid` false the 16 bytes are zero-filled and nothing
// is read.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest group of this thread's copies is still in
// flight.
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying `rows` rows of `cols` bf16 (cols % 8 == 0) from global rows
// of stride `gld` to shared rows of stride `sld`, 16 bytes a thread; rows
// past `valid` are zero.
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int sld,
                                      const __nv_bfloat16* src, size_t gld,
                                      int rows, int valid, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 8;
    const bool ok = r < valid;
    copy16(dst + r * sld + c, ok ? src + r * gld + c : src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
ffn_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2,
                const __nv_bfloat16* __restrict__ b2,
                __nv_bfloat16* __restrict__ y, int N, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Bf16Layout lay(D);
  const int ld = D + kPadBf16;
  const int cld = kChunkBf16 + kPadBf16;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + lay.x);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + lay.w1);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + lay.w2);
  __nv_bfloat16* ins = reinterpret_cast<__nv_bfloat16*>(smem + lay.inner);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's row group
  const int t = lane % 4;  // the thread's place in it
  const int row0 = blockIdx.x * kRows;
  const int valid = min(kRows, N - row0);
  // copy groups, oldest first: x with the first W1 chunk, the first W2
  // chunk, then per chunk the next W1 chunk (during this chunk's second
  // product) and the next W2 chunk (during the next chunk's first product)
  const int fc0 = min(kChunkBf16, F);
  stage(xs, ld, x + static_cast<size_t>(row0) * D, D, kRows, valid, D);
  stage(w1s, ld, w1, D, fc0, fc0, D);
  commit();
  stage(w2s, cld, w2, F, D, D, fc0);
  commit();

  // the output [32][D]: warp w owns the 8-column tiles w, w + 8, ... of
  // both 16-row halves
  constexpr int kTiles = kMaxD / 8 / kWarps;
  const int n_tiles = D / 8;
  float acc[2][kTiles][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunkBf16) {
    const int fc = min(kChunkBf16, F - f0);  // a multiple of 16
    const int next = f0 + kChunkBf16;
    const int fn = next < F ? min(kChunkBf16, F - next) : 0;
    wait_all_but_newest();  // x and this W1 chunk have landed
    __syncthreads();

    // inner chunk [32][fc]: warp w takes the 8 columns 8w.. of both halves
    if (warp * 8 < fc) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const __nv_bfloat16* wrow = w1s + warp * 8 * ld;
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t b[2], a[4];
        load_b(b, wrow + k0, ld, g, t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          load_a(a, xs + h * 16 * ld + k0, ld, g, t);
          mma_bf16(c[h], a, b);
        }
      }
      const int col = warp * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = h * 16 + g + (e >= 2 ? 8 : 0);
          const int cc = col + (e & 1);
          const float v = bf16_add(c[h][e], b1[f0 + cc]);
          ins[r * cld + cc] = __float2bfloat16_rn(relu(v));
        }
    }
    __syncthreads();  // the W1 chunk is read by every warp, the inner written
    if (fn > 0)
      stage(w1s, ld, w1 + static_cast<size_t>(next) * D, D, fn, fn, D);
    commit();               // an empty group after the last chunk
    wait_all_but_newest();  // this W2 chunk has landed
    __syncthreads();

    // acc += inner chunk [32][fc] . (W2 columns f0..)^T
    for (int k0 = 0; k0 < fc; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) load_a(a[h], ins + h * 16 * cld + k0, cld,
                                         g, t);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int tile = warp + j * kWarps;
        if (tile < n_tiles) {
          uint32_t b[2];
          load_b(b, w2s + tile * 8 * cld + k0, cld, g, t);
#pragma unroll
          for (int h = 0; h < 2; ++h) mma_bf16(acc[h][j], a[h], b);
        }
      }
    }
    __syncthreads();  // the W2 chunk and the inner are read by every warp
    if (fn > 0) stage(w2s, cld, w2 + next, F, D, D, fn);
    commit();
  }

#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int tile = warp + j * kWarps;
    if (tile >= n_tiles) continue;
    const int col = tile * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = h * 16 + g + 8 * half;
        if (r >= valid) continue;
        __nv_bfloat162 out;
        out.x = __float2bfloat16_rn(bf16_add(acc[h][j][2 * half], b2[col]));
        out.y = __float2bfloat16_rn(
            bf16_add(acc[h][j][2 * half + 1], b2[col + 1]));
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<size_t>(row0 + r) * D + col) = out;
      }
  }
}

// D > kMaxD: block (i, j) takes rows 32i.. and output columns 512j.. . The
// shared layout is the narrow kernel's at D = 512: an x slice [32][512 + 8],
// a W1 chunk slice [64][512 + 8], the W2 chunk of the group's rows
// [512][64 + 8] and the inner chunk [32][64 + 8].
__global__ void __launch_bounds__(kThreads)
ffn_bf16_wide_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w1,
                     const __nv_bfloat16* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const __nv_bfloat16* __restrict__ b2,
                     __nv_bfloat16* __restrict__ y, int N, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Bf16Layout lay(kMaxD);
  const int ld = kMaxD + kPadBf16;
  const int cld = kChunkBf16 + kPadBf16;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + lay.x);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + lay.w1);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + lay.w2);
  __nv_bfloat16* ins = reinterpret_cast<__nv_bfloat16*>(smem + lay.inner);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * kRows;
  const int valid = min(kRows, N - row0);
  const int c0 = blockIdx.y * kMaxD;      // the group's first output column
  const int n_tiles = min(kMaxD, D - c0) / 8;

  constexpr int kTiles = kMaxD / 8 / kWarps;
  float acc[2][kTiles][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunkBf16) {
    const int fc = min(kChunkBf16, F - f0);  // a multiple of 16
    // inner chunk [32][fc] over D in slices of 512
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < D; k0 += kMaxD) {
      const int kc = min(kMaxD, D - k0);
      __syncthreads();  // the previous slice is read by every warp
      stage(xs, ld, x + static_cast<size_t>(row0) * D + k0, D, kRows, valid,
            kc);
      stage(w1s, ld, w1 + static_cast<size_t>(f0) * D + k0, D, fc, fc, kc);
      commit();
      wait_all();
      __syncthreads();
      if (warp * 8 < fc) {
        const __nv_bfloat16* wrow = w1s + warp * 8 * ld;
        for (int kk = 0; kk < kc; kk += 16) {
          uint32_t b[2], a[4];
          load_b(b, wrow + kk, ld, g, t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            load_a(a, xs + h * 16 * ld + kk, ld, g, t);
            mma_bf16(c[h], a, b);
          }
        }
      }
    }
    if (warp * 8 < fc) {
      const int col = warp * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = h * 16 + g + (e >= 2 ? 8 : 0);
          const int cc = col + (e & 1);
          const float v = bf16_add(c[h][e], b1[f0 + cc]);
          ins[r * cld + cc] = __float2bfloat16_rn(relu(v));
        }
    }
    // the group's W2 rows, columns f0..f0 + fc (the previous chunk's
    // product finished before the slice loop's barrier)
    stage(w2s, cld, w2 + static_cast<size_t>(c0) * F + f0, F, n_tiles * 8,
          n_tiles * 8, fc);
    commit();
    wait_all();
    __syncthreads();  // the inner chunk and the W2 chunk are in place

    for (int k0 = 0; k0 < fc; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) load_a(a[h], ins + h * 16 * cld + k0, cld,
                                         g, t);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int tile = warp + j * kWarps;
        if (tile < n_tiles) {
          uint32_t b[2];
          load_b(b, w2s + tile * 8 * cld + k0, cld, g, t);
#pragma unroll
          for (int h = 0; h < 2; ++h) mma_bf16(acc[h][j], a[h], b);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int tile = warp + j * kWarps;
    if (tile >= n_tiles) continue;
    const int col = c0 + tile * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = h * 16 + g + 8 * half;
        if (r >= valid) continue;
        __nv_bfloat162 out;
        out.x = __float2bfloat16_rn(bf16_add(acc[h][j][2 * half], b2[col]));
        out.y = __float2bfloat16_rn(
            bf16_add(acc[h][j][2 * half + 1], b2[col + 1]));
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<size_t>(row0 + r) * D + col) = out;
      }
  }
}

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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// dtype_code 0: float32, 1: bfloat16. x [N, D], w1 [F, D], b1 [F], w2 [D, F],
// b2 [D] -> y [N, D], all of that type and contiguous, bf16 pointers
// 16-byte aligned. Sizes outside the limits above are refused with
// cudaErrorInvalidValue before anything is launched. D <= 512 takes the
// narrow kernels, wider D the wide ones.
int asr_fused_ffn(int dtype_code, const void* x, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* y,
                  int N, int D, int F, void* stream) {
  if (D < 16 || D % 16 != 0 || F < 16 || F % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > kMaxD;
  const dim3 grid((N + kRows - 1) / kRows, wide ? (D + kMaxD - 1) / kMaxD : 1);
  if (dtype_code == 1) {
    const size_t smem = Bf16Layout(wide ? kMaxD : D).total;
    auto kernel = wide ? ffn_bf16_wide_kernel : ffn_bf16_kernel;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w1),
        static_cast<const __nv_bfloat16*>(b1),
        static_cast<const __nv_bfloat16*>(w2),
        static_cast<const __nv_bfloat16*>(b2),
        static_cast<__nv_bfloat16*>(y), N, D, F);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype_code == 0) {
    const size_t smem = F32Layout(wide ? kMaxD : D).total;
    auto kernel = wide ? ffn_f32_wide_kernel : ffn_f32_kernel;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(y), N, D, F);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
