// Trainable fused NeRF backbone for Hopper (sm_90a): forward and backward,
// bf16 tensor cores with f32 accumulation.
//
// Replaces the TPU kernels playableenvironments_tpu/ops/fused_nerf.py::
// _fwd_backbone_kernel (forward, launched by _run_fwd_backbone) and
// _bwd_backbone_kernel (backward, launched by _fused_backbone_bwd): the
// L-layer, W-wide ReLU backbone over the positional encoding, with the
// encoding concatenated back in at `skip`, plus the alpha head
// alpha = h . w_alpha + b_alpha. Every product takes bf16 operands;
// accumulation, biases, ReLU, the backbone output h and all gradients are f32.
//
// Bound: at the tennis widths (W 256, 8 layers, encoding 63) one point costs
// 491,264 MAC forward, and the backward three times that (recompute, input
// gradient, weight gradient), against 1.3 KB (forward) and 1.5 KB (backward)
// of inputs and outputs per point: both kernels are bound by tensor-core
// operations, not by bytes.
//
// Forward (backbone_fwd_kernel): one CTA of 8 warps per tile of 64 points,
// B1's tile scheme (csrc/fused_nerf.cu): activations stay in shared memory
// as bf16 (h in columns [0, W), the encoding in [W, W + 64)), weights stream
// from L2 into WMMA fragments, accumulators go through an f32 stage.
//
// Backward, three kernels, every sum in a fixed order (no atomics), so the
// gradients are bit-identical run to run:
// 1. backbone_bwd_tile_kernel, one CTA per 64-point tile: recomputes the
//    forward, writing each layer's bf16 activation to a global scratch X
//    (N_pad x (64 + L W)); back-propagates through the ReLU chain (the
//    masks read back from X), writing each layer's masked bf16 gradient to
//    a scratch G (N_pad x L W) and the tile's f32 column sums (db) and
//    alpha-head partials to a per-tile row; accumulates d_encoded on chip.
//    The TPU kernel keeps all 8 activations of a 512-point block in VMEM
//    (~4 KB a point in bf16); one SM's 227 KB would hold them for ~48
//    points, so they go to X instead, which the weight-gradient products
//    read anyway. bf16 loses nothing there: the backward uses activations
//    only as bf16 matmul operands and as ReLU masks, and bf16 rounding
//    keeps the sign of an f32.
// 2. backbone_dw_partial_kernel: dW = X_in^T G per layer as a split-K
//    product. CTA (row block of 64 weight rows, chunk of 4096 points)
//    writes its f32 partial to its own slab.
// 3. backbone_grad_reduce_kernel: sums the slabs over chunks and the
//    per-tile rows over tiles, each in index order.
// The TPU kernel instead zeroes shared dW outputs at program_id 0 and +=s
// into them across a sequential grid; CTAs run concurrently here.
//
// Weight layout (built by ops/fused_nerf.py::backbone_buffers), bf16, each
// matrix row-major (K, W), concatenated: layer 0 (64, W) with rows [pe, 64)
// zero; layer `skip` (W + 64, W), rows [0, W) for h and [W, W + pe) for the
// encoding, the rest zero; other layers (W, W); then w_alpha (W). Biases,
// f32: b_0 .. b_{L-1} (W each), b_alpha (1). Weight-gradient rows use the
// same padded row order (1,920 rows at the tennis widths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kRows = 64;  // points per CTA tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWidth = 256;
constexpr int kPe = 64;                       // encoding columns, zero-padded
constexpr int kLda = kMaxWidth + kPe + 8;     // bf16 activation row stride
constexpr int kLdcFwd = kMaxWidth + 4;        // f32 stage stride, forward
constexpr int kLdcBwd = kMaxWidth + kPe + 4;  // f32 stage stride, backward
constexpr int kChunk = 4096;                  // points per weight-gradient slab
constexpr size_t kFwdSmem =
    (size_t)kRows * kLda * sizeof(bf16) + (size_t)kRows * kLdcFwd * sizeof(float);
constexpr size_t kBwdSmem = (size_t)kRows * kLda * sizeof(bf16) +
                            (size_t)kRows * kLdcBwd * sizeof(float) +
                            (size_t)kRows * kPe * sizeof(float) + kRows * sizeof(float);

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// C[0:64, 0:n] = A[0:64, 0:k] @ B. A in shared memory (stride kLda); B is
// (k, n), read from global memory either as W row-major (ld = ldw) or, when
// kTransposedB, as the transpose of a row-major (n, k) matrix W (B = W^T,
// ld = ldw). k and n are multiples of 16, n <= 256. Warp w owns column
// tiles w and w + 8.
template <bool kTransposedB>
__device__ __forceinline__ void tile_matmul(const bf16* a, int k, const bf16* w, int ldw,
                                            int n, float* c, int ldc) {
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
    for (int r = 0; r < 4; ++r) wmma::load_matrix_sync(af[r], a + r * 16 * kLda + kk, kLda);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ct = warp + j * kWarps;
      if (ct < n_tiles) {
        if constexpr (kTransposedB) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
          wmma::load_matrix_sync(bfrag, w + (size_t)ct * 16 * ldw + kk, ldw);
#pragma unroll
          for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[j][r], af[r], bfrag, acc[j][r]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
          wmma::load_matrix_sync(bfrag, w + (size_t)kk * ldw + ct * 16, ldw);
#pragma unroll
          for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[j][r], af[r], bfrag, acc[j][r]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ct = warp + j * kWarps;
    if (ct < n_tiles) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wmma::store_matrix_sync(c + r * 16 * ldc + ct * 16, acc[j][r], ldc, wmma::mem_row_major);
    }
  }
}

__device__ __forceinline__ int layer_in_rows(int i, int width, int skip) {
  return i == 0 ? kPe : (i == skip ? width + kPe : width);
}

// The tile's forward: loads the encodings (rounded to bf16, zero-padded to
// kPe columns) into a[:, W:W+kPe], then runs the L layers. Afterwards
// a[:, 0:W] holds bf16(h) and c[:, 0:W] the f32 post-ReLU h of the last
// layer. With x_out, the encodings and every layer's bf16 activation are
// also written to the scratch X (columns [0, kPe) and kPe + i W + [0, W)).
__device__ void backbone_forward(const float* __restrict__ encoded, const bf16* __restrict__ weights,
                                 const float* __restrict__ biases, bf16* a, float* c, int ldc,
                                 int row0, int n_points, int pe, int width, int layers, int skip,
                                 bf16* __restrict__ x_out, int ldx) {
  for (int idx = threadIdx.x; idx < kRows * kPe; idx += kThreads) {
    const int r = idx / kPe, col = idx % kPe;
    const int point = row0 + r;
    const float v = (point < n_points && col < pe) ? encoded[(size_t)point * pe + col] : 0.0f;
    const bf16 b16 = __float2bfloat16(v);
    a[r * kLda + width + col] = b16;
    if (x_out != nullptr) x_out[(size_t)point * ldx + col] = b16;
  }
  __syncthreads();

  const bf16* w = weights;
  const float* b = biases;
  for (int i = 0; i < layers; ++i) {
    const int a_col = (i == 0) ? width : 0;
    const int k = layer_in_rows(i, width, skip);
    tile_matmul<false>(a + a_col, k, w, width, width, c, ldc);
    w += (size_t)k * width;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * width; idx += kThreads) {
      const int r = idx / width, col = idx % width;
      const float v = fmaxf(c[r * ldc + col] + b[col], 0.0f);
      c[r * ldc + col] = v;
      const bf16 b16 = __float2bfloat16(v);
      a[r * kLda + col] = b16;
      if (x_out != nullptr) x_out[(size_t)(row0 + r) * ldx + kPe + i * width + col] = b16;
    }
    b += width;
    __syncthreads();
  }
}

__device__ __forceinline__ size_t backbone_weight_count(int width, int layers, int skip) {
  size_t count = 0;
  for (int i = 0; i < layers; ++i) count += (size_t)layer_in_rows(i, width, skip) * width;
  return count;
}

__global__ void __launch_bounds__(kThreads)
    backbone_fwd_kernel(const float* __restrict__ encoded, const bf16* __restrict__ weights,
                        const float* __restrict__ biases, float* __restrict__ h_out,
                        float* __restrict__ alpha_out, int n_points, int pe, int width,
                        int layers, int skip) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* c = reinterpret_cast<float*>(smem + (size_t)kRows * kLda * sizeof(bf16));
  const int row0 = blockIdx.x * kRows;

  backbone_forward(encoded, weights, biases, a, c, kLdcFwd, row0, n_points, pe, width, layers,
                   skip, nullptr, 0);

  for (int idx = threadIdx.x; idx < kRows * width; idx += kThreads) {
    const int r = idx / width, col = idx % width;
    const int point = row0 + r;
    if (point < n_points) h_out[(size_t)point * width + col] = c[r * kLdcFwd + col];
  }

  // Alpha head: 4 threads per row, f32 dot products of the bf16 h and w_alpha.
  const bf16* w_alpha = weights + backbone_weight_count(width, layers, skip);
  const float b_alpha = biases[(size_t)layers * width];
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int seg = width / 4;
  float s = 0.0f;
  for (int col = q * seg; col < (q + 1) * seg; ++col)
    s += __bfloat162float(a[r * kLda + col]) * __bfloat162float(w_alpha[col]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (q == 0 && row0 + r < n_points) alpha_out[row0 + r] = s + b_alpha;
}

// Per-tile row of `tile_part` (ld = L W + W + 1): [L W] db_i column sums,
// [W] alpha-head weight partials, [1] alpha-head bias partial.
__global__ void __launch_bounds__(kThreads)
    backbone_bwd_tile_kernel(const float* __restrict__ encoded, const float* __restrict__ g_h,
                             const float* __restrict__ g_alpha, const bf16* __restrict__ weights,
                             const float* __restrict__ biases, float* __restrict__ d_encoded,
                             bf16* __restrict__ x_scr, bf16* __restrict__ g_scr,
                             float* __restrict__ tile_part, int n_points, int pe, int width,
                             int layers, int skip) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  float* c = reinterpret_cast<float*>(smem + (size_t)kRows * kLda * sizeof(bf16));
  float* denc = c + kRows * kLdcBwd;
  float* ga = denc + kRows * kPe;
  const int row0 = blockIdx.x * kRows;
  const int ldx = kPe + layers * width;
  const int ldg = layers * width;
  const int tp_ld = layers * width + width + 1;
  float* tp = tile_part + (size_t)blockIdx.x * tp_ld;

  backbone_forward(encoded, weights, biases, a, c, kLdcBwd, row0, n_points, pe, width, layers,
                   skip, x_scr, ldx);

  const bf16* w_alpha = weights + backbone_weight_count(width, layers, skip);
  if (threadIdx.x < kRows) {
    const int point = row0 + threadIdx.x;
    ga[threadIdx.x] = point < n_points ? g_alpha[point] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < kRows * kPe; idx += kThreads) denc[idx] = 0.0f;
  __syncthreads();

  // Alpha head: dW_alpha partial = bf16(h)^T bf16(g_alpha), db_alpha = sum g_alpha.
  for (int col = threadIdx.x; col < width; col += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += __bfloat162float(a[r * kLda + col]) * bf(ga[r]);
    tp[layers * width + col] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += ga[r];
    tp[layers * width + width] = s;
  }
  // g = g_h + bf16(g_alpha) bf16(w_alpha)^T.
  for (int idx = threadIdx.x; idx < kRows * width; idx += kThreads) {
    const int r = idx / width, col = idx % width;
    const int point = row0 + r;
    const float gh = point < n_points ? g_h[(size_t)point * width + col] : 0.0f;
    c[r * kLdcBwd + col] = gh + bf(ga[r]) * __bfloat162float(w_alpha[col]);
  }
  __syncthreads();

  for (int i = layers - 1; i >= 0; --i) {
    // Mask by the layer's ReLU; the bf16 gradient goes to `a` (this
    // layer's matmul operand) and to the scratch G.
    for (int idx = threadIdx.x; idx < kRows * width; idx += kThreads) {
      const int r = idx / width, col = idx % width;
      const size_t point = row0 + r;
      const float act = __bfloat162float(x_scr[point * ldx + kPe + i * width + col]);
      const float v = act > 0.0f ? c[r * kLdcBwd + col] : 0.0f;
      c[r * kLdcBwd + col] = v;
      const bf16 b16 = __float2bfloat16(v);
      a[r * kLda + col] = b16;
      g_scr[point * ldg + i * width + col] = b16;
    }
    __syncthreads();
    for (int col = threadIdx.x; col < width; col += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += c[r * kLdcBwd + col];
      tp[i * width + col] = s;
    }
    __syncthreads();

    // g_in = bf16(g) @ bf16(w_i)^T.
    size_t offset = 0;
    for (int j = 0; j < i; ++j) offset += (size_t)layer_in_rows(j, width, skip) * width;
    const bf16* w_i = weights + offset;
    if (i == 0) {
      tile_matmul<true>(a, width, w_i, width, kPe, c, kLdcBwd);
    } else {
      tile_matmul<true>(a, width, w_i, width, width, c, kLdcBwd);
      if (i == skip)
        tile_matmul<true>(a, width, w_i + (size_t)width * width, width, kPe, c + width, kLdcBwd);
    }
    __syncthreads();
    if (i == skip || i == 0) {
      const int col0 = (i == 0) ? 0 : width;
      for (int idx = threadIdx.x; idx < kRows * kPe; idx += kThreads) {
        const int r = idx / kPe, col = idx % kPe;
        denc[idx] += c[r * kLdcBwd + col0 + col];
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < kRows * kPe; idx += kThreads) {
    const int r = idx / kPe, col = idx % kPe;
    const int point = row0 + r;
    if (point < n_points && col < pe) d_encoded[(size_t)point * pe + col] = denc[idx];
  }
}

// partial[chunk, rows] = X_in[chunk points]^T G[chunk points] for the 64
// padded weight-gradient rows of row block blockIdx.x, over the points of
// chunk blockIdx.y.
__global__ void __launch_bounds__(kThreads)
    backbone_dw_partial_kernel(const bf16* __restrict__ x_scr, const bf16* __restrict__ g_scr,
                               float* __restrict__ partial, int n_pad, int rows_pad, int width,
                               int layers, int skip) {
  const int ldx = kPe + layers * width;
  const int ldg = layers * width;
  const int row = blockIdx.x * kRows;

  // Which layer these rows belong to, and the X columns that feed them.
  int layer = 0, start = 0;
  while (row >= start + layer_in_rows(layer, width, skip)) {
    start += layer_in_rows(layer, width, skip);
    ++layer;
  }
  const int off = row - start;
  int a_col;
  if (layer == 0)
    a_col = off;  // the encodings
  else if (off < width)
    a_col = kPe + (layer - 1) * width + off;  // the previous layer's activation
  else
    a_col = off - width;  // the skip layer's encoding rows
  const int g_col = layer * width;

  const int warp = threadIdx.x / 32;
  const int n_tiles = width / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[j][r], 0.0f);

  const int k0 = blockIdx.y * kChunk;
  const int k1 = min(n_pad, k0 + kChunk);
  for (int kk = k0; kk < k1; kk += 16) {
    // A = X_in^T: element (m, k) at x_scr[(kk + k) * ldx + a_col + m].
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wmma::load_matrix_sync(af[r], x_scr + (size_t)kk * ldx + a_col + r * 16, ldx);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ct = warp + j * kWarps;
      if (ct < n_tiles) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, g_scr + (size_t)kk * ldg + g_col + ct * 16, ldg);
#pragma unroll
        for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[j][r], af[r], bfrag, acc[j][r]);
      }
    }
  }
  float* out = partial + ((size_t)blockIdx.y * rows_pad + row) * width;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ct = warp + j * kWarps;
    if (ct < n_tiles) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wmma::store_matrix_sync(out + r * 16 * width + ct * 16, acc[j][r], width,
                                wmma::mem_row_major);
    }
  }
}

// out[e] = sum over chunks of partial (e < dw_elems), then sum over tiles of
// the per-tile rows; each sum in index order.
__global__ void backbone_grad_reduce_kernel(const float* __restrict__ partial, int chunks,
                                            size_t dw_elems, const float* __restrict__ tile_part,
                                            int tiles, int tp_ld, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < dw_elems) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * dw_elems + e];
    out[e] = s;
  } else if (e < dw_elems + tp_ld) {
    const size_t j = e - dw_elems;
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += tile_part[(size_t)t * tp_ld + j];
    out[e] = s;
  }
}

int rows_padded(int width, int layers, int skip) {
  int rows = 0;
  for (int i = 0; i < layers; ++i) rows += i == 0 ? kPe : (i == skip ? width + kPe : width);
  return rows;
}

}  // namespace

// Each launcher runs on `stream` and returns the CUDA error code (0 on
// success). Shapes and limits (width % 64 == 0, width <= 256, pe <= 64,
// 0 < skip < layers) and the scratch sizes are checked by the Python wrapper
// (ops/fused_nerf.py), which allocates every buffer.
extern "C" int fused_backbone_fwd_launch(const void* encoded, const void* weights,
                                         const void* biases, void* h_out, void* alpha_out,
                                         int n_points, int pe, int width, int layers, int skip,
                                         void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      backbone_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n_points + kRows - 1) / kRows;
  backbone_fwd_kernel<<<tiles, kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      (const float*)encoded, (const bf16*)weights, (const float*)biases, (float*)h_out,
      (float*)alpha_out, n_points, pe, width, layers, skip);
  return (int)cudaGetLastError();
}

// Scratch: x_scr bf16 (tiles 64, 64 + L W); g_scr bf16 (tiles 64, L W);
// tile_part f32 (tiles, L W + W + 1); partial f32 (chunks, rows_pad, W).
// grads_out f32: (rows_pad, W) weight gradients in the padded row order,
// then db_0 .. db_{L-1}, dW_alpha (W), db_alpha (1).
extern "C" int fused_backbone_bwd_launch(const void* encoded, const void* g_h, const void* g_alpha,
                                         const void* weights, const void* biases, void* d_encoded,
                                         void* x_scr, void* g_scr, void* tile_part, void* partial,
                                         void* grads_out, int n_points, int pe, int width,
                                         int layers, int skip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      backbone_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n_points + kRows - 1) / kRows;
  const int n_pad = tiles * kRows;
  const int chunks = (n_pad + kChunk - 1) / kChunk;
  const int rows_pad = rows_padded(width, layers, skip);
  const int tp_ld = layers * width + width + 1;

  backbone_bwd_tile_kernel<<<tiles, kThreads, kBwdSmem, s>>>(
      (const float*)encoded, (const float*)g_h, (const float*)g_alpha, (const bf16*)weights,
      (const float*)biases, (float*)d_encoded, (bf16*)x_scr, (bf16*)g_scr, (float*)tile_part,
      n_points, pe, width, layers, skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  backbone_dw_partial_kernel<<<dim3(rows_pad / kRows, chunks), kThreads, 0, s>>>(
      (const bf16*)x_scr, (const bf16*)g_scr, (float*)partial, n_pad, rows_pad, width, layers,
      skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t dw_elems = (size_t)rows_pad * width;
  const size_t total = dw_elems + tp_ld;
  backbone_grad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const float*)partial, chunks, dw_elems, (const float*)tile_part, tiles, tp_ld,
      (float*)grads_out);
  return (int)cudaGetLastError();
}
