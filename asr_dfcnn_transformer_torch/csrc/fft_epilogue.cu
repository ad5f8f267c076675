// The last stage of the matmul inverse real FFT (ops/matfft.py
// irfft_matmul, epilogue "pallas") for the PyTorch port.
//
// Replaces asr_dfcnn_transformer_tpu/ops/pallas/fft_epilogue.py
// interleave_epilogue (its pallas_call and the body _epilogue_kernel). From
// the DFT stages' output zr, zi [B, n2, n1] (float32 or bfloat16) it writes
//
//   x[b, 2 (m2 + n2 m1) + p] = f32(z_p[b, m2, m1]) * (1 / n),  n = 2 n1 n2
//
// as float32: the [n2, n1] -> [n1, n2] transpose, the even/odd interleave
// of the real and imaginary parts, the upcast and the exact power-of-two
// scale, in one read of z and one write of x. The values are those of the
// plain relayout (kernels/fft_epilogue.py), bit for bit: the scale is
// applied after the upcast, and 1/n is exact.
//
// Bound: bytes. At batch 128, n 262,144 and bf16 z ([128, 256, 512] twice)
// it reads 67.1 MB and writes 134.2 MB: 0.0601 ms at 3.35 TB/s. The TPU
// kernel held one batch row's whole [n2, n1] pair in VMEM and transposed it
// there; a block here has 227 KB of shared memory, so the relayout runs as
// a tiled transpose. A block of 32 x 8 threads takes a 32 x 32 tile of
// (m2, m1): each warp reads tile rows of zr and zi coalesced along m1,
// upcasts and scales them into two shared tiles padded by one column (no
// bank conflicts on the transposed read), then writes each m1 row of the
// tile as 32 consecutive (re, im) float2 pairs, 256 bytes a warp. Ragged
// tiles (n1 or n2 below 32, down to n 16: [2, 4]) are masked. No tensor
// cores and no TMA: a pure relayout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // blockDim.y
constexpr int kMaxGridZ = 65535;

template <typename T>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
interleave_epilogue_kernel(const T* __restrict__ zr,
                           const T* __restrict__ zi, float* __restrict__ out,
                           int B, int n2, int n1, float inv_n) {
  __shared__ float tr[kTile][kTile + 1];
  __shared__ float ti[kTile][kTile + 1];
  const int m1_0 = blockIdx.x * kTile;
  const int m2_0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const size_t per_row = static_cast<size_t>(n2) * n1;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const T* zr_b = zr + b * per_row;
    const T* zi_b = zi + b * per_row;
    // read: tile row r is z[m2_0 + r, m1_0 + tx]
    for (int r = ty; r < kTile; r += kRowsPerPass) {
      const int m2 = m2_0 + r;
      const int m1 = m1_0 + tx;
      if (m2 < n2 && m1 < n1) {
        const size_t i = static_cast<size_t>(m2) * n1 + m1;
        tr[r][tx] = to_f32(zr_b[i]) * inv_n;
        ti[r][tx] = to_f32(zi_b[i]) * inv_n;
      }
    }
    __syncthreads();
    // write: output row m1 = m1_0 + c, the pair (re, im) of m2 = m2_0 + tx
    float2* out_b = reinterpret_cast<float2*>(out + 2 * b * per_row);
    for (int c = ty; c < kTile; c += kRowsPerPass) {
      const int m1 = m1_0 + c;
      const int m2 = m2_0 + tx;
      if (m1 < n1 && m2 < n2)
        out_b[static_cast<size_t>(m1) * n2 + m2] =
            make_float2(tr[tx][c], ti[tx][c]);
    }
    __syncthreads();  // the tiles are read before the next row overwrites
  }
}

template <typename T>
cudaError_t launch(const void* zr, const void* zi, float* out, int B, int n2,
                   int n1, float inv_n, cudaStream_t s) {
  const dim3 block(kTile, kRowsPerPass);
  const dim3 grid((n1 + kTile - 1) / kTile, (n2 + kTile - 1) / kTile,
                  B < kMaxGridZ ? B : kMaxGridZ);
  interleave_epilogue_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(zr), static_cast<const T*>(zi), out, B, n2, n1,
      inv_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_code 0: float32, 1: bfloat16. zr, zi [B, n2, n1] of that type,
// contiguous -> out [B, n1, 2 n2] float32 (the length-2 n1 n2 signal),
// scaled by inv_n. n1 and n2 below 1 or above 65535 tiles return
// cudaErrorInvalidValue before anything is launched.
int asr_interleave_epilogue(int dtype_code, const void* zr, const void* zi,
                            void* out, int B, int n2, int n1, float inv_n,
                            void* stream) {
  if (n1 < 1 || n2 < 1 || (n2 + kTile - 1) / kTile > kMaxGridZ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype_code == 0)
    return static_cast<int>(launch<float>(zr, zi, o, B, n2, n1, inv_n, s));
  if (dtype_code == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(zr, zi, o, B, n2, n1, inv_n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
