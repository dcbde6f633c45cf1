// Trainable fused NeRF backbone for Hopper (sm_90a) in full f32: forward and
// backward with exact f32 products (FFMA on the CUDA cores) and f32 sums.
//
// Replaces the TPU kernels playableenvironments_tpu/ops/fused_nerf.py::
// _fwd_backbone_kernel and _bwd_backbone_kernel run with compute_dtype
// float32 (every product's `mm` dtype f32): the L-layer, W-wide ReLU backbone
// over the positional encoding, the encoding concatenated back in at `skip`,
// plus the alpha head alpha = h . w_alpha + b_alpha, and its backward
// (recompute, dX, dW, db). csrc/fused_backbone.cu is the bf16 version on
// wgmma; TF32 tensor cores would round the operands to 10 bits, so this one
// is a simple tiled FFMA kernel (a 3xTF32 redesign is left for later).
//
// Weight images (ops/fused_nerf.py::backbone_f32_buffers), f32, row-major:
// `fwd` holds each layer's padded (rows_i x W) weight: layer 0 the encoding
// rows zero-padded to 64, layer `skip` W activation rows then 64 encoding
// rows, every other layer W rows; then w_alpha (W). `bwd` holds each layer's
// transpose (W x rows_i), at the same offsets. Biases: b_0 .. b_{L-1},
// b_alpha.
//
// Products: a CTA of 256 threads owns a tile of 64 points with its
// activations in shared memory (row stride W + 4, so that two rows a warp
// reads fall in different banks); a thread accumulates 64 * OW / 256 outputs
// (OW/32 points x 8 columns) in registers while the weight streams through
// shared memory in slices of 16 rows (one 256 x 256 f32 weight, 256 KB, is
// more than a CTA's shared memory). The accumulators then overwrite the tile
// in place.
//
// Forward (backbone_f32_fwd_kernel): one CTA per tile; the alpha head is a
// quad-shuffle dot product, h goes out from the registers.
// Backward, three kernels, every sum in a fixed order (no atomics on global
// memory), so the gradients are bit-identical from launch to launch:
// 1. backbone_f32_bwd_tile_kernel, persistent over the tiles of one chunk:
//    recomputes the forward, keeping each layer's ReLU mask as bits in shared
//    memory and storing each layer's input X (the encoding, then every
//    activation but the last) to a scratch, then back-propagates: masks g,
//    stores G, adds db and the alpha head's partials into its CTA's row of
//    column sums, forms g @ W_i^T (the encoding part into d_encoded);
// 2. backbone_f32_dw_kernel: dW_i = X_i^T G_i over output tiles of 128
//    padded weight rows x 128 columns, each CTA over one split of the
//    chunk's points, added into that split's f32 slab;
// 3. backbone_f32_grad_reduce_kernel: sums the slabs over splits and the
//    tile kernel's rows, each in index order.
// The launcher walks the points in chunks of `chunk_tiles` tiles (1,024,
// ops/fused_nerf.py::_F32_CHUNK_TILES) so that the X and G scratch stay
// bounded, ~1 GB at the tennis widths (backbone_f32_scratch_shapes); the dW
// slabs and the column-sum rows accumulate across chunks in place.
//
// Times on the card and what they are held against: PERF.md (chip_smoke.py
// phase 14a).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // points a tile
constexpr int kThreads = 256;
constexpr int kSlice = 16;         // weight rows a shared-memory slice
constexpr int kPe = 64;            // the encoding, zero-padded
constexpr int kEncStride = kPe + 4;
constexpr int kMaxLayers = 8;
constexpr int kDwPoints = 32;      // points a dW slice

__host__ __device__ constexpr int act_stride(int W) { return W + 4; }

__host__ __device__ inline int rows_of(int layer, int W, int skip) {
  return layer == 0 ? kPe : (layer == skip ? W + kPe : W);
}

// Floats of the weight image before `layer` (fwd and bwd alike).
__device__ inline size_t layer_offset(int layer, int W, int skip) {
  size_t off = 0;
  for (int i = 0; i < layer; ++i) off += (size_t)rows_of(i, W, skip) * W;
  return off;
}

// acc[i][j] += sum_k in[row_i][k] * w[k][col_j] over k < K, where row_i =
// pg * PPT + i of the tile in shared memory (row stride in_stride) and the
// thread's 8 columns are c0 .. c0 + 3 and OW/2 + c0 .. + 3 (c0 = 4 cg) of
// w, row-major in global memory with row stride w_stride. The weight is
// staged through `ws` (kSlice x OW floats) a slice at a time.
template <int OW>
__device__ __forceinline__ void mm_acc(float (&acc)[OW / 32][8], const float* in, int in_stride, int K,
                                       const float* __restrict__ w, int w_stride, float* ws) {
  constexpr int CG = OW / 8, PPT = OW / 32;
  const int t = threadIdx.x;
  const int cg = t % CG, pg = t / CG;
  const int c0 = 4 * cg;
  const float* rows = in + (size_t)pg * PPT * in_stride;
  for (int k0 = 0; k0 < K; k0 += kSlice) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = t; idx < kSlice * OW / 4; idx += kThreads) {
      const int r = idx / (OW / 4), q = idx % (OW / 4);
      reinterpret_cast<float4*>(ws)[idx] = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k0 + r) * w_stride) + q);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlice; k += 4) {
      float4 a[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) a[i] = *reinterpret_cast<const float4*>(rows + i * in_stride + k0 + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wa = *reinterpret_cast<const float4*>(ws + (k + kk) * OW + c0);
        const float4 wb = *reinterpret_cast<const float4*>(ws + (k + kk) * OW + OW / 2 + c0);
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float x = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(x, wa.x, acc[i][0]);
          acc[i][1] = fmaf(x, wa.y, acc[i][1]);
          acc[i][2] = fmaf(x, wa.z, acc[i][2]);
          acc[i][3] = fmaf(x, wa.w, acc[i][3]);
          acc[i][4] = fmaf(x, wb.x, acc[i][4]);
          acc[i][5] = fmaf(x, wb.y, acc[i][5]);
          acc[i][6] = fmaf(x, wb.z, acc[i][6]);
          acc[i][7] = fmaf(x, wb.w, acc[i][7]);
        }
      }
    }
  }
}

template <int OW>
__device__ __forceinline__ int acc_col(int j) {
  const int c0 = 4 * (threadIdx.x % (OW / 8));
  return j < 4 ? c0 + j : OW / 2 + c0 + j - 4;
}

template <int OW>
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x / (OW / 8)) * (OW / 32) + i;
}

template <int OW>
__device__ __forceinline__ void zero(float (&acc)[OW / 32][8]) {
#pragma unroll
  for (int i = 0; i < OW / 32; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// The tile's encodings (rows p0 .. p0 + 63, pe columns), zero-padded.
__device__ void load_encoding(float* enc, const float* __restrict__ encoded, int p0, int n, int pe) {
  for (int idx = threadIdx.x; idx < kTile * kPe; idx += kThreads) {
    const int r = idx / kPe, c = idx % kPe;
    enc[r * kEncStride + c] = (p0 + r < n && c < pe) ? encoded[(size_t)(p0 + r) * pe + c] : 0.0f;
  }
}

// One forward layer into registers: acc = relu(input @ W_layer + b).
template <int W>
__device__ __forceinline__ void forward_layer(float (&acc)[W / 32][8], const float* buf, const float* enc,
                                              const float* __restrict__ wf, const float* __restrict__ bias,
                                              int layer, int skip, float* ws) {
  const float* wl = wf + layer_offset(layer, W, skip);
  zero<W>(acc);
  if (layer == 0) {
    mm_acc<W>(acc, enc, kEncStride, kPe, wl, W, ws);
  } else {
    mm_acc<W>(acc, buf, act_stride(W), W, wl, W, ws);
    if (layer == skip) mm_acc<W>(acc, enc, kEncStride, kPe, wl + (size_t)W * W, W, ws);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float b = bias[layer * W + acc_col<W>(j)];
#pragma unroll
    for (int i = 0; i < W / 32; ++i) acc[i][j] = fmaxf(acc[i][j] + b, 0.0f);
  }
}

template <int OW>
__device__ __forceinline__ void store_tile(float* buf, int stride, const float (&acc)[OW / 32][8]) {
#pragma unroll
  for (int i = 0; i < OW / 32; ++i) {
    float* row = buf + acc_row<OW>(i) * stride;
    *reinterpret_cast<float4*>(row + acc_col<OW>(0)) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + acc_col<OW>(4)) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// alpha = h . w_alpha + b_alpha for the tile's 64 points: four threads a
// point, each a quarter of the columns, summed by two shuffles.
template <int W>
__device__ __forceinline__ float alpha_head(const float* buf, const float* __restrict__ w_alpha) {
  const int p = threadIdx.x / 4, part = threadIdx.x % 4;
  const float* row = buf + p * act_stride(W);
  float s = 0.0f;
  for (int c = part * (W / 4); c < (part + 1) * (W / 4); ++c) s = fmaf(row[c], w_alpha[c], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

template <int W>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)kTile * act_stride(W) + kTile * kEncStride + kSlice * W);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    backbone_f32_fwd_kernel(const float* __restrict__ encoded, const float* __restrict__ wf,
                            const float* __restrict__ bias, float* __restrict__ h_out, float* __restrict__ alpha_out,
                            int n, int pe, int layers, int skip) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* enc = buf + kTile * act_stride(W);
  float* ws = enc + kTile * kEncStride;
  const int p0 = blockIdx.x * kTile;
  load_encoding(enc, encoded, p0, n, pe);
  float acc[W / 32][8];
  for (int layer = 0; layer < layers; ++layer) {
    forward_layer<W>(acc, buf, enc, wf, bias, layer, skip, ws);
    __syncthreads();  // every thread has read the tile
    store_tile<W>(buf, act_stride(W), acc);
  }
#pragma unroll
  for (int i = 0; i < W / 32; ++i) {
    const int p = p0 + acc_row<W>(i);
    if (p < n) {
      float* row = h_out + (size_t)p * W;
      *reinterpret_cast<float4*>(row + acc_col<W>(0)) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + acc_col<W>(4)) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  const float* w_alpha = wf + layer_offset(layers, W, skip);
  const float a = alpha_head<W>(buf, w_alpha) + bias[layers * W];
  const int p = p0 + threadIdx.x / 4;
  if (threadIdx.x % 4 == 0 && p < n) alpha_out[p] = a;
}

// ---- backward ---------------------------------------------------------------

struct BwdTileParams {
  const float* encoded;
  const float* g_h;
  const float* g_alpha;
  const float* wf;
  const float* wb;
  const float* bias;
  float* d_encoded;
  float* x_scr;      // (chunk rows, x_ld): the encoding, then activations 0 .. L-2
  float* g_scr;      // (chunk rows, g_ld): G_0 .. G_{L-1}
  float* tile_part;  // (grid, tp_ld): db_0 .. db_{L-1}, dW_alpha, db_alpha
  int n, pe, layers, skip;
  int chunk_begin;   // first point of the chunk
  int chunk_tiles;
  int x_ld, g_ld, tp_ld;
};

template <int W>
constexpr size_t bwd_smem() {
  return sizeof(float) * ((size_t)kTile * act_stride(W) + kTile * kEncStride + kSlice * W +
                          (size_t)kMaxLayers * kTile * W / 32 + ((kMaxLayers * W + W + 1 + 3) / 4) * 4);
}

// Column sums of the tile (64 rows of buf) added into sums[0 .. W): one
// thread a column, rows in order.
template <int W>
__device__ __forceinline__ void add_column_sums(float* sums, const float* buf) {
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kTile; ++r) s += buf[r * act_stride(W) + c];
    sums[c] += s;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) backbone_f32_bwd_tile_kernel(const __grid_constant__ BwdTileParams p) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* enc = buf + kTile * act_stride(W);
  float* ws = enc + kTile * kEncStride;
  uint32_t* masks = reinterpret_cast<uint32_t*>(ws + kSlice * W);
  float* sums = reinterpret_cast<float*>(masks + kMaxLayers * kTile * W / 32);
  const int t = threadIdx.x;
  const int L = p.layers;
  for (int i = t; i < p.tp_ld; i += kThreads) sums[i] = p.tile_part[(size_t)blockIdx.x * p.tp_ld + i];
  const float* w_alpha = p.wf + layer_offset(L, W, p.skip);

  for (int tile = blockIdx.x; tile < p.chunk_tiles; tile += gridDim.x) {
    const int local0 = tile * kTile;        // first scratch row
    const int p0 = p.chunk_begin + local0;  // first point
    __syncthreads();
    load_encoding(enc, p.encoded, p0, p.n, p.pe);
    for (int i = t; i < L * kTile * W / 32; i += kThreads) masks[i] = 0u;
    __syncthreads();
    for (int idx = t; idx < kTile * kPe; idx += kThreads) {
      const int r = idx / kPe, c = idx % kPe;
      p.x_scr[(size_t)(local0 + r) * p.x_ld + c] = enc[r * kEncStride + c];
    }
    // Recompute, keeping masks and each layer's output but the last in X.
    float acc[W / 32][8];
    for (int layer = 0; layer < L; ++layer) {
      forward_layer<W>(acc, buf, enc, p.wf, p.bias, layer, p.skip, ws);
      __syncthreads();
      store_tile<W>(buf, act_stride(W), acc);
#pragma unroll
      for (int i = 0; i < W / 32; ++i) {
        const int r = acc_row<W>(i);
        uint32_t lo = 0u, hi = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo |= (acc[i][j] > 0.0f ? 1u : 0u) << ((acc_col<W>(j)) % 32);
          hi |= (acc[i][j + 4] > 0.0f ? 1u : 0u) << ((acc_col<W>(j + 4)) % 32);
        }
        uint32_t* row = masks + (layer * kTile + r) * (W / 32);
        atomicOr(row + acc_col<W>(0) / 32, lo);
        atomicOr(row + acc_col<W>(4) / 32, hi);
      }
      __syncthreads();
      if (layer < L - 1) {
        const int col = kPe + layer * W;
        for (int idx = t; idx < kTile * W / 4; idx += kThreads) {
          const int r = idx / (W / 4), q = idx % (W / 4);
          *reinterpret_cast<float4*>(p.x_scr + (size_t)(local0 + r) * p.x_ld + col + 4 * q) =
              *reinterpret_cast<const float4*>(buf + r * act_stride(W) + 4 * q);
        }
      }
    }
    // The alpha head: dW_alpha += h^T g_alpha, db_alpha += sum g_alpha.
    for (int c = t; c < W; c += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kTile; ++r) {
        const int q = p0 + r;
        s += buf[r * act_stride(W) + c] * (q < p.n ? p.g_alpha[q] : 0.0f);
      }
      sums[L * W + c] += s;
    }
    if (t == 0) {
      float s = 0.0f;
      for (int r = 0; r < kTile; ++r) s += p0 + r < p.n ? p.g_alpha[p0 + r] : 0.0f;
      sums[L * W + W] += s;
    }
    __syncthreads();
    // g = g_h + g_alpha w_alpha^T.
    for (int idx = t; idx < kTile * W; idx += kThreads) {
      const int r = idx / W, c = idx % W, q = p0 + r;
      buf[r * act_stride(W) + c] = q < p.n ? p.g_h[(size_t)q * W + c] + p.g_alpha[q] * w_alpha[c] : 0.0f;
    }
    for (int layer = L - 1; layer >= 0; --layer) {
      __syncthreads();
      for (int idx = t; idx < kTile * W; idx += kThreads) {
        const int r = idx / W, c = idx % W;
        const uint32_t bit = (masks[(layer * kTile + r) * (W / 32) + c / 32] >> (c % 32)) & 1u;
        if (!bit) buf[r * act_stride(W) + c] = 0.0f;
      }
      __syncthreads();
      for (int idx = t; idx < kTile * W / 4; idx += kThreads) {
        const int r = idx / (W / 4), q = idx % (W / 4);
        *reinterpret_cast<float4*>(p.g_scr + (size_t)(local0 + r) * p.g_ld + layer * W + 4 * q) =
            *reinterpret_cast<const float4*>(buf + r * act_stride(W) + 4 * q);
      }
      add_column_sums<W>(sums + layer * W, buf);
      const float* wt = p.wb + layer_offset(layer, W, p.skip);
      const int rows = rows_of(layer, W, p.skip);
      if (layer == 0 || layer == p.skip) {
        // The encoding's rows: d_encoded (the skip layer's come first).
        // Layer 0 adds onto the skip layer's terms where there is one.
        const bool add = layer == 0 && p.skip < L;
        float acc64[2][8];
        zero<64>(acc64);
        mm_acc<64>(acc64, buf, act_stride(W), W, wt + (layer == 0 ? 0 : W), rows, ws);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float* e = enc + acc_row<64>(i) * kEncStride + acc_col<64>(j);
            *e = add ? *e + acc64[i][j] : acc64[i][j];
          }
      }
      if (layer > 0) {
        zero<W>(acc);
        mm_acc<W>(acc, buf, act_stride(W), W, wt, rows, ws);
        __syncthreads();
        store_tile<W>(buf, act_stride(W), acc);
      }
    }
    __syncthreads();
    for (int idx = t; idx < kTile * kPe; idx += kThreads) {
      const int r = idx / kPe, c = idx % kPe, q = p0 + r;
      if (q < p.n && c < p.pe) p.d_encoded[(size_t)q * p.pe + c] = enc[r * kEncStride + c];
    }
  }
  __syncthreads();
  for (int i = t; i < p.tp_ld; i += kThreads) p.tile_part[(size_t)blockIdx.x * p.tp_ld + i] = sums[i];
}

// dW over one chunk: block (row block rb, column block cb) of the padded
// weight gradient, points [split * per_split, ...) of the chunk. Each row
// block is two 64-row halves whose X columns the table gives (-1: none).
struct DwParams {
  const float* x_scr;
  const float* g_scr;
  const int* table;  // per row block: out_row, xcol_a, xcol_b, layer
  float* partial;    // (splits, rows_pad, W)
  int rows;          // scratch rows of the chunk (whole tiles)
  int per_split;     // points a split, a multiple of kDwPoints
  int x_ld, g_ld, rows_pad, width;
};

__global__ void __launch_bounds__(kThreads) backbone_f32_dw_kernel(const __grid_constant__ DwParams p) {
  __shared__ __align__(16) float xs[kDwPoints][128];
  __shared__ __align__(16) float gs[kDwPoints][128];
  const int col_blocks = (p.width + 127) / 128;
  const int rb = blockIdx.x / col_blocks, cb = blockIdx.x % col_blocks;
  const int out_row = p.table[4 * rb], xa = p.table[4 * rb + 1], xb = p.table[4 * rb + 2];
  const int layer = p.table[4 * rb + 3];
  const int gcol = layer * p.width + cb * 128;
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  const int begin = blockIdx.y * p.per_split;
  const int end = min(begin + p.per_split, p.rows);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = begin; k0 < end; k0 += kDwPoints) {
    __syncthreads();
    for (int idx = t; idx < kDwPoints * 32; idx += kThreads) {
      const int r = idx / 32, q = idx % 32, col = 4 * q, half = col / 64;
      const int xcol = half ? xb : xa;
      const size_t row = (size_t)(k0 + r);
      const bool in = k0 + r < end;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), g = x;
      if (in && xcol >= 0) x = *reinterpret_cast<const float4*>(p.x_scr + row * p.x_ld + xcol + col % 64);
      if (in) g = *reinterpret_cast<const float4*>(p.g_scr + row * p.g_ld + gcol + col);
      *reinterpret_cast<float4*>(&xs[r][col]) = x;
      *reinterpret_cast<float4*>(&gs[r][col]) = g;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kDwPoints; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(&xs[k][4 * tr]);
      const float4 x1 = *reinterpret_cast<const float4*>(&xs[k][64 + 4 * tr]);
      const float4 g0 = *reinterpret_cast<const float4*>(&gs[k][4 * tc]);
      const float4 g1 = *reinterpret_cast<const float4*>(&gs[k][64 + 4 * tc]);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
    }
  }
  float* slab = p.partial + (size_t)blockIdx.y * p.rows_pad * p.width;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4;
    if ((r < 64 ? xa : xb) < 0) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb * 128 + (j < 4 ? 4 * tc + j : 64 + 4 * tc + j - 4);
      if (c < p.width) slab[(size_t)(out_row + r) * p.width + c] += acc[i][j];
    }
  }
}

// grads_out[j] = sum over splits of partial[s][j] (the padded dW), then the
// tile kernel's rows summed for db, dW_alpha and db_alpha; each in order.
__global__ void backbone_f32_grad_reduce_kernel(const float* __restrict__ partial, int splits, size_t dw_elems,
                                                const float* __restrict__ tile_part, int rows, int tp_ld,
                                                float* __restrict__ out) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < dw_elems) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * dw_elems + j];
    out[j] = s;
  } else if (j < dw_elems + tp_ld) {
    const size_t c = j - dw_elems;
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += tile_part[(size_t)r * tp_ld + c];
    out[j] = s;
  }
}

template <int W>
cudaError_t prepare() {
  static bool done = false;  // per process; the port runs one card a process
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(backbone_f32_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)fwd_smem<W>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(backbone_f32_bwd_tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bwd_smem<W>());
  done = err == cudaSuccess;
  return err;
}

template <int W>
int fwd_launch(const float* encoded, const float* wf, const float* bias, float* h, float* alpha, int n, int pe,
               int layers, int skip, cudaStream_t stream) {
  cudaError_t err = prepare<W>();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTile - 1) / kTile;
  backbone_f32_fwd_kernel<W><<<tiles, kThreads, fwd_smem<W>(), stream>>>(encoded, wf, bias, h, alpha, n, pe,
                                                                         layers, skip);
  return (int)cudaGetLastError();
}

template <int W>
int bwd_launch(const float* encoded, const float* g_h, const float* g_alpha, const float* wf, const float* wb,
               const float* bias, float* d_encoded, float* x_scr, float* g_scr, float* tile_part, float* partial,
               const int* table, int row_blocks, float* grads_out, int n, int pe, int layers, int skip, int grid,
               int chunk_tiles, int splits, int x_ld, int g_ld, cudaStream_t stream) {
  cudaError_t err = prepare<W>();
  if (err != cudaSuccess) return (int)err;
  int rows_pad = 0;
  for (int i = 0; i < layers; ++i) rows_pad += rows_of(i, W, skip);
  const int tp_ld = layers * W + W + 1;
  const size_t dw_elems = (size_t)rows_pad * W;
  err = cudaMemsetAsync(tile_part, 0, sizeof(float) * (size_t)grid * tp_ld, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)splits * dw_elems, stream);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTile - 1) / kTile;
  const int col_blocks = (W + 127) / 128;
  for (int first = 0; first < tiles; first += chunk_tiles) {
    const int count = min(chunk_tiles, tiles - first);
    BwdTileParams tp{encoded, g_h, g_alpha, wf, wb, bias, d_encoded, x_scr, g_scr, tile_part, n, pe, layers,
                     skip, first * kTile, count, x_ld, g_ld, tp_ld};
    backbone_f32_bwd_tile_kernel<W><<<grid, kThreads, bwd_smem<W>(), stream>>>(tp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rows = count * kTile;
    int per_split = (rows + splits - 1) / splits;
    per_split = (per_split + kDwPoints - 1) / kDwPoints * kDwPoints;
    DwParams dp{x_scr, g_scr, table, partial, rows, per_split, x_ld, g_ld, rows_pad, W};
    backbone_f32_dw_kernel<<<dim3(row_blocks * col_blocks, splits), kThreads, 0, stream>>>(dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t total = dw_elems + tp_ld;
  backbone_f32_grad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, splits, dw_elems, tile_part, grid, tp_ld, grads_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher runs on `stream` and returns the CUDA error code (0 on
// success). Shapes and limits (width in {64, 128, 256}, pe <= 64, layers <=
// 8, skip == layers for none), the grid, chunk and split counts, the row
// block table and every buffer come from the Python wrapper
// (ops/fused_nerf.py).
extern "C" int backbone_f32_fwd_launch(const void* encoded, const void* wf, const void* bias, void* h, void* alpha,
                                       int n, int pe, int width, int layers, int skip, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FWD(W) \
  fwd_launch<W>((const float*)encoded, (const float*)wf, (const float*)bias, (float*)h, (float*)alpha, n, pe, layers, skip, s)
  switch (width) {
    case 64: return FWD(64);
    case 128: return FWD(128);
    case 256: return FWD(256);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int backbone_f32_bwd_launch(const void* encoded, const void* g_h, const void* g_alpha, const void* wf,
                                       const void* wb, const void* bias, void* d_encoded, void* x_scr, void* g_scr,
                                       void* tile_part, void* partial, const void* table, int row_blocks,
                                       void* grads_out, int n, int pe, int width, int layers, int skip, int grid,
                                       int chunk_tiles, int splits, int x_ld, int g_ld, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BWD(W)                                                                                                    \
  bwd_launch<W>((const float*)encoded, (const float*)g_h, (const float*)g_alpha, (const float*)wf,              \
                (const float*)wb, (const float*)bias, (float*)d_encoded, (float*)x_scr, (float*)g_scr,          \
                (float*)tile_part, (float*)partial, (const int*)table, row_blocks, (float*)grads_out, n, pe,     \
                layers, skip, grid, chunk_tiles, splits, x_ld, g_ld, s)
  switch (width) {
    case 64: return BWD(64);
    case 128: return BWD(128);
    case 256: return BWD(256);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
