// Fused eval AdaIN-NeRF MLP for Hopper (sm_90a), bf16 tensor cores with f32
// accumulation.
//
// Replaces the TPU kernel playableenvironments_tpu/ops/fused_nerf.py::
// _fused_kernel (launched by fused_adain_nerf). Per point: an L-layer,
// W-wide ReLU backbone over a bf16 positional encoding, with the encoding
// concatenated back in at `skip`; alpha = h . w_alpha + b_alpha; the feature
// head f = ReLU((h @ W_f0) * scale0 + bias0), f = ReLU((f @ W_f1) * scale1 +
// bias1), features = f @ W_out + b_out. Every product takes bf16 operands
// (activations are rounded to bf16 before each one); accumulation, biases,
// ReLU and the modulation are f32. scale*/bias* are stored per RAY and
// broadcast over the `samples` consecutive points of each ray (row / samples).
//
// Bound: at the tennis widths (W 256, 8 layers, encoding 63, 192 outputs)
// one point costs ~614k MAC, against ~0.9 KB of input and output, so the
// kernel is bound by tensor-core operations (~1.23 MFLOP per point: 57 us per
// 46,080-point launch at the H100's dense bf16 peak), not by bytes.
//
// Design (first, simple version): one CTA of 8 warps per tile of 64 points.
// The tile's activations stay in shared memory as bf16 for the whole MLP
// (h in columns [0, W), the encoding in [W, W + pe_pad)), so the skip
// concatenation is a wider K range over the same rows and nothing but the
// outputs goes back to device memory. Weights (~1.2 MB bf16 per object, too
// large for one SM) stream from L2 straight into WMMA fragments; each warp
// owns up to two 16-column output tiles of all 64 rows. Accumulators go
// through an f32 shared-memory stage where bias, ReLU and modulation are
// applied and the bf16 activations are rewritten. wgmma, TMA and a
// persistent schedule are left for later.
//
// Weight layout (built by ops/fused_nerf.py::kernel_weights), bf16, each
// matrix row-major (K, N), concatenated in this order:
//   layer 0: (pe_pad, W); layer `skip`: (W + pe_pad, W) with rows [0, W) for
//   h and [W, W + pe) for the encoding; other layers (W, W);
//   w_alpha (W); W_f0 (W, W); W_f1 (W, W/2); W_out (W/2, out_pad).
// Padding rows/columns are zero. Biases, f32: b_0..b_{L-1} (W each),
// b_alpha (1), b_out (out).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kRows = 64;      // points per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWidth = 256;
constexpr int kMaxPe = 64;
constexpr int kLda = kMaxWidth + kMaxPe + 8;  // bf16 activations row stride
constexpr int kLdc = kMaxWidth + 4;           // f32 accumulator row stride
constexpr size_t kSmemBytes =
    (size_t)kRows * kLda * sizeof(bf16) + (size_t)kRows * kLdc * sizeof(float);

// C[0:64, 0:n] = A[0:64, 0:k] @ W[0:k, 0:n]; A in shared memory (stride kLda),
// W row-major in global memory, C in shared memory (stride kLdc). k and n are
// multiples of 16, n <= 256. Warp w owns column tiles w and w + 8.
__device__ __forceinline__ void tile_matmul(const bf16* a, int k, const bf16* w,
                                            int n, float* c) {
  const int warp = threadIdx.x / 32;
  const int n_tiles = n / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[j][r], 0.0f);

  for (int kk = 0; kk < k; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wmma::load_matrix_sync(af[r], a + r * 16 * kLda + kk, kLda);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ct = warp + j * kWarps;
      if (ct < n_tiles) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, w + (size_t)kk * n + ct * 16, n);
#pragma unroll
        for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[j][r], af[r], bfrag, acc[j][r]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ct = warp + j * kWarps;
    if (ct < n_tiles) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wmma::store_matrix_sync(c + r * 16 * kLdc + ct * 16, acc[j][r], kLdc,
                                wmma::mem_row_major);
    }
  }
}

// A[:, 0:n] = bf16(ReLU(C * scale[ray] + bias[ray])) with per-ray modulation,
// or bf16(ReLU(C + bias)) when scale is null (bias then per column).
__device__ __forceinline__ void activate(const float* c, bf16* a, int n, int row0,
                                         int n_points, int samples,
                                         const float* scale, const float* bias) {
  for (int idx = threadIdx.x; idx < kRows * n; idx += kThreads) {
    const int r = idx / n, col = idx % n;
    float v = c[r * kLdc + col];
    if (scale == nullptr) {
      v += bias[col];
    } else {
      const int point = min(row0 + r, n_points - 1);
      const size_t m = (size_t)(point / samples) * n + col;
      v = v * scale[m] + bias[m];
    }
    a[r * kLda + col] = __float2bfloat16(fmaxf(v, 0.0f));
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_adain_nerf_kernel(const bf16* __restrict__ encoded,
                            const float* __restrict__ scale0,
                            const float* __restrict__ bias0,
                            const float* __restrict__ scale1,
                            const float* __restrict__ bias1,
                            const bf16* __restrict__ weights,
                            const float* __restrict__ biases,
                            float* __restrict__ features_out,
                            float* __restrict__ alpha_out, int n_points,
                            int samples, int pe, int width, int layers, int skip,
                            int out_features) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* c = reinterpret_cast<float*>(smem + (size_t)kRows * kLda * sizeof(bf16));

  const int row0 = blockIdx.x * kRows;
  const int pe_pad = (pe + 15) & ~15;
  const int half = width / 2;
  const int out_pad = (out_features + 15) & ~15;

  // The tile's encodings, zero-padded to pe_pad columns and kRows rows.
  for (int idx = threadIdx.x; idx < kRows * pe_pad; idx += kThreads) {
    const int r = idx / pe_pad, col = idx % pe_pad;
    const int point = row0 + r;
    bf16 v = __float2bfloat16(0.0f);
    if (point < n_points && col < pe) v = encoded[(size_t)point * pe + col];
    a[r * kLda + width + col] = v;
  }
  __syncthreads();

  const bf16* w = weights;
  const float* b = biases;
  for (int i = 0; i < layers; ++i) {
    const int a_col = (i == 0) ? width : 0;
    const int k = (i == 0) ? pe_pad : (i == skip ? width + pe_pad : width);
    tile_matmul(a + a_col, k, w, width, c);
    w += (size_t)k * width;
    __syncthreads();
    activate(c, a, width, row0, n_points, samples, nullptr, b);
    b += width;
    __syncthreads();
  }

  // Alpha head (one output column): 4 threads per row, f32 dot products of
  // the bf16 activations and weights.
  {
    const bf16* w_alpha = w;
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const int seg = width / 4;
    float s = 0.0f;
    for (int col = q * seg; col < (q + 1) * seg; ++col)
      s += __bfloat162float(a[r * kLda + col]) * __bfloat162float(w_alpha[col]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0 && row0 + r < n_points) alpha_out[row0 + r] = s + b[0];
  }
  w += width;
  b += 1;

  // Feature head. The alpha head above reads `a` before this sync.
  tile_matmul(a, width, w, width, c);
  w += (size_t)width * width;
  __syncthreads();
  activate(c, a, width, row0, n_points, samples, scale0, bias0);
  __syncthreads();

  tile_matmul(a, width, w, half, c);
  w += (size_t)width * half;
  __syncthreads();
  activate(c, a, half, row0, n_points, samples, scale1, bias1);
  __syncthreads();

  tile_matmul(a, half, w, out_pad, c);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * out_features; idx += kThreads) {
    const int r = idx / out_features, col = idx % out_features;
    const int point = row0 + r;
    if (point < n_points)
      features_out[(size_t)point * out_features + col] = c[r * kLdc + col] + b[col];
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success). Shapes and
// limits (width % 32 == 0, width <= 256, pe <= 64, out_features <= 256,
// 0 < skip) are checked by the Python wrapper.
extern "C" int fused_adain_nerf_launch(const void* encoded, const void* scale0,
                                       const void* bias0, const void* scale1,
                                       const void* bias1, const void* weights,
                                       const void* biases, void* features_out,
                                       void* alpha_out, int n_points, int samples,
                                       int pe, int width, int layers, int skip,
                                       int out_features, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_adain_nerf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_points + kRows - 1) / kRows;
  fused_adain_nerf_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)encoded, (const float*)scale0, (const float*)bias0,
      (const float*)scale1, (const float*)bias1, (const bf16*)weights,
      (const float*)biases, (float*)features_out, (float*)alpha_out, n_points,
      samples, pe, width, layers, skip, out_features);
  return (int)cudaGetLastError();
}
