// Trainable fused NeRF backbone for Hopper (sm_90a): forward and backward on
// wgmma (bf16 operands, f32 accumulation), fed by bulk asynchronous copies.
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
// 491,264 MAC forward and three times that backward (recompute, input
// gradient, weight gradient), against 1.3 KB (forward) and 1.5 KB
// (backward) of inputs and outputs: both are bound by tensor-core operations.
// What the design has to keep off the critical path is everything else: the
// 983 KB bf16 weight image, which every 128-point tile reads from L2 (forward
// once, backward twice), and, in the backward, the bf16 activations and
// cotangents that the weight-gradient product reads back from memory.
//
// Weight image (built by ops/fused_nerf.py::backbone_buffers): a sequence of
// slots, each 64 weight rows (input features) x W columns of bf16, stored as
// W/64 blocks of 64 x 64 in which row r is 128 bytes whose 16-byte chunks are
// XOR-ed with r % 8: the layout that wgmma's 128-byte swizzle mode reads, so
// that one bulk copy lands a slot ready to use. Layer 0 is one slot (the
// encoding rows, zero-padded from pe to 64); layer `skip` is W/64 slots of h
// rows then one of encoding rows; every other layer W/64 slots. w_alpha (W
// bf16, plain) follows the last slot. Biases, f32: b_0 .. b_{L-1}, b_alpha.
//
// Forward (backbone_fwd_kernel): one persistent CTA per SM walks 128-point
// tiles. One thread of a producer warpgroup (whose other registers go to the
// consumers by setmaxnreg) streams the slots of every layer of every tile
// through a ring in shared memory, bulk copies completing on mbarriers; two
// consumer warpgroups, 64 rows each, run m64nWk16 wgmma with A = the tile's
// bf16 activations (K-major, in shared memory, the encoding columns beside
// them for the skip layer) and B = the slot (MN-major). Bias and ReLU run on
// the accumulators in registers, which then overwrite the warpgroup's own
// rows of the activation tile in place. The alpha head is a quad-shuffle dot
// product in the last epilogue, h goes out in f32 from registers.
//
// Backward, three kernels, every sum in a fixed order (no atomics), so the
// gradients are bit-identical from launch to launch on one card:
// 1. backbone_bwd_tile_kernel, persistent like the forward and sharing its
//    layer routine: recomputes the forward, keeping each layer's ReLU mask
//    as bits in shared memory and bulk-storing each layer's bf16 input X to a
//    scratch in 64-point x 64-column swizzled blocks; then back-propagates:
//    masks g, stores bf16 G the same way, adds db and the alpha head's
//    partials as fixed-order column sums into its CTA's row for the
//    warpgroup, and forms g @ W_i^T with m64n64k16 wgmma reading the same
//    slots K-major (one slot = 64 output columns). The encoding slots come
//    first in their layers, so their d_encoded terms form in registers that
//    are free at that point and go straight to d_encoded.
// 2. backbone_dw_kernel: dW_i = X_in^T G_i as a wgmma GEMM over output tiles
//    of 128 padded weight rows x W (one 64-row block per warpgroup), K over
//    the points of one chunk, both operands MN-major blocks streamed by bulk
//    copies through a 4-stage ring; one f32 slab per chunk.
// 3. backbone_grad_reduce_kernel: sums the slabs over chunks and the tile
//    kernel's rows, each in index order.
// The TPU kernel instead zeroes shared dW outputs at program_id 0 and +=s
// into them across a sequential grid; CTAs run concurrently here.
//
// Times on the card, per kernel and per sub-kernel, and what sets each
// one's pace: PERF.md (chip_smoke.py phase 5, scripts/ablate_backbone_bwd.py).

#include "nerf_wgmma.cuh"

namespace {

constexpr int kMaxLayers = 8;     // the backward's ReLU-mask bits in shared memory
constexpr int kFwdStages = 4, kBwdStages = 3, kDwStages = 4;
constexpr int kMaskBytes = kMaxLayers * 256 * 4 * 4;
constexpr int kStagingBytes = 8 * 256 * 4;  // per-warp column sums
constexpr int kDwStageBytes = 2 * 8192 + kSlotBytes;
constexpr size_t kFwdSmem = 1024 + (size_t)kFwdStages * kSlotBytes + kActBytes + kEncBytes + 256;
constexpr size_t kBwdSmem =
    1024 + (size_t)kBwdStages * kSlotBytes + kActBytes + kEncBytes + kMaskBytes + kStagingBytes + 256;
constexpr size_t kDwSmem = 1024 + (size_t)kDwStages * kDwStageBytes + 256;

// ---- B3's column sums -----------------------------------------------------------

// Halves the values `s` a lane keeps, summing them with lane ^ M's other half.
template <int H, int M>
__device__ __forceinline__ void reduce_scatter(float* s, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? s[k] : s[k + H];
    const float keep = up ? s[k + H] : s[k];
    s[k] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// out[c] = sum over the warpgroup's 64 rows of v at column c, c < W, or
// out[c] += that sum unless `first`: each thread sums its two rows; the
// warp's 8 row groups by a reduce-scatter over lane bits 2-4 (three rounds
// of shuffles, each halving the columns a lane keeps); then the 4 warps in
// order through the warpgroup's `staging`. `out` is the row of this CTA and
// warpgroup, so the sum over its tiles is taken in a fixed order too.
template <int W>
__device__ __forceinline__ void column_sums(const float* v, float* staging, float* __restrict__ out, int wg, int t,
                                            bool first) {
  constexpr int N = W / 4;  // a thread's values: column pairs of its 2 rows summed
  const int lane = t & 31, q = lane & 3;
  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = v[4 * (n >> 1) + (n & 1)] + v[4 * (n >> 1) + 2 + (n & 1)];
  reduce_scatter<N / 2, 4>(s, lane);
  reduce_scatter<N / 4, 8>(s, lane);
  reduce_scatter<N / 8, 16>(s, lane);
  const int base = ((lane >> 2) & 1) * (N / 2) + ((lane >> 3) & 1) * (N / 4) + ((lane >> 4) & 1) * (N / 8);
#pragma unroll
  for (int k = 0; k < N / 8; ++k) {
    const int n = base + k;
    staging[(t >> 5) * 256 + 8 * (n >> 1) + 2 * q + (n & 1)] = s[k];
  }
  named_sync(1 + wg, 128);
  for (int c = t; c < W; c += 128) {
    const float sum = staging[c] + staging[256 + c] + staging[512 + c] + staging[768 + c];
    out[c] = first ? sum : out[c] + sum;
  }
  named_sync(1 + wg, 128);
}

// ---- B2: forward ---------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    backbone_fwd_kernel(const float* __restrict__ encoded, const bf16* __restrict__ weights,
                        const float* __restrict__ biases, float* __restrict__ h_out, float* __restrict__ alpha_out,
                        int n_points, int pe, int layers, int skip) {
  constexpr int nb = W / 64;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const uint32_t act = sm.addr + kFwdStages * kSlotBytes, enc = act + kActBytes;
  Ring ring;
  init_ring(ring, sm.addr, enc + kEncBytes, kFwdStages, 8);
  const int tiles = (n_points + kTile - 1) / kTile;
  const uint32_t slot_bytes = 128 * W;
  const int total_slots = first_slot(layers, nb, skip);

  if (threadIdx.x >= kConsumers) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      const unsigned char* image = reinterpret_cast<const unsigned char*>(weights);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        produce_slots<kFwdStages>(ring, image, slot_bytes, 0, total_slots);
    }
  } else {
    reg_alloc<232>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t & 31, q = lane & 3;
    unsigned char* act_p = sm.base + kFwdStages * kSlotBytes;
    unsigned char* enc_p = act_p + kActBytes;
    const bf16* w_alpha = weights + (size_t)total_slots * 64 * W;
    const float b_alpha = __ldg(biases + layers * W);
    float acc[W / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile * kTile;
      named_sync(1 + wg, 128);  // the previous tile's products are done with the encodings
      load_encoding(encoded, enc_p, wg, row0, n_points, pe, t);
      fence_async_smem();
      named_sync(1 + wg, 128);
      for (int i = 0; i < layers; ++i) {
        forward_layer<W, kFwdStages>(acc, ring, i, skip, act, enc, wg, lane);
        bias_relu<W>(acc, biases + i * W, t);
        if (i + 1 < layers) {
          named_sync(1 + wg, 128);  // every warp's products have read the tile
          store_tile<W>(act_p, acc, wg, t);
          fence_async_smem();
          named_sync(1 + wg, 128);
        }
      }
      // h in f32 and alpha = bf16(h) . bf16(w_alpha) + b_alpha.
      const int r0 = row0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float wa0 = __bfloat162float(w_alpha[col]), wa1 = __bfloat162float(w_alpha[col + 1]);
        s0 += __bfloat162float(__float2bfloat16(acc[4 * j])) * wa0 +
              __bfloat162float(__float2bfloat16(acc[4 * j + 1])) * wa1;
        s1 += __bfloat162float(__float2bfloat16(acc[4 * j + 2])) * wa0 +
              __bfloat162float(__float2bfloat16(acc[4 * j + 3])) * wa1;
        if (r0 < n_points)
          *reinterpret_cast<float2*>(h_out + (size_t)r0 * W + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < n_points)
          *reinterpret_cast<float2*>(h_out + (size_t)(r0 + 8) * W + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (q == 0 && r0 < n_points) alpha_out[r0] = s0 + b_alpha;
      if (q == 0 && r0 + 8 < n_points) alpha_out[r0 + 8] = s1 + b_alpha;
    }
  }
}

// ---- B3: backward --------------------------------------------------------------

// Scratch layouts: X and G are arrays of swizzled 64-point x 64-column blocks
// (the shared-memory layout of the tiles above, 8 KB each), block (p, c) at
// (p * columns + c) * kBlock for point block p (points 64 p .. 64 p + 63).
// X column blocks: 0 the encoding, 1 + i (W / 64) + j layer i's bf16
// activation (i < L - 1). G column blocks: i (W / 64) + j layer i's masked
// bf16 cotangent.

// One backward slot product for the warpgroup: out (64 columns) += g @
// slot^T, g the activation tile (K-major over W columns), the slot K-major.
template <int W, int kStages>
__device__ __forceinline__ void backward_slot(float* out, Ring& r, int& prev, uint32_t act, int wg, int lane,
                                              bool accumulate) {
  consume_slot<kStages>(r, prev, lane, [&](uint32_t slot) {
    const uint64_t da = sw128_base(act + wg * 64 * 128, 16, 1024), db = sw128_base(slot, 16, 1024);
#pragma unroll
    for (int k = 0; k < W / 16; ++k)
      wgmma<64, 0, 0>(out, da + (k >> 2) * (kTile * 128 / 16) + (k & 3) * 2, db + (k >> 2) * 512 + (k & 3) * 2,
                      (accumulate || k > 0) ? 1 : 0);
  });
}

// Row 2 blockIdx.x + warpgroup of `tile_part` (ld = L W + W + 1) sums, over
// the CTA's tiles, the warpgroup's [L W] db_i column sums, [W] alpha-head
// weight partials and [1] alpha-head bias partial.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    backbone_bwd_tile_kernel(const bf16* __restrict__ encoded, const float* __restrict__ g_h,
                             const float* __restrict__ g_alpha, const bf16* __restrict__ weights,
                             const float* __restrict__ biases, float* __restrict__ d_encoded, bf16* __restrict__ x_scr,
                             bf16* __restrict__ g_scr, float* __restrict__ tile_part, int n_points, int pe, int layers,
                             int skip) {
  constexpr int nb = W / 64;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const uint32_t act = sm.addr + kBwdStages * kSlotBytes, enc = act + kActBytes;
  Ring ring;
  init_ring(ring, sm.addr, enc + kEncBytes + kMaskBytes + kStagingBytes, kBwdStages, 8);
  const int tiles = (n_points + kTile - 1) / kTile;
  const uint32_t slot_bytes = 128 * W;
  const int total_slots = first_slot(layers, nb, skip);

  if (threadIdx.x >= kConsumers) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      const unsigned char* image = reinterpret_cast<const unsigned char*>(weights);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        produce_slots<kBwdStages>(ring, image, slot_bytes, 0, total_slots);
        for (int i = layers - 1; i >= 0; --i) {  // the skip layer's encoding slot first
          const int first = first_slot(i, nb, skip);
          if (i == skip) produce_slots<kBwdStages>(ring, image, slot_bytes, first + nb, 1);
          produce_slots<kBwdStages>(ring, image, slot_bytes, first, i == skip ? nb : layer_slots(i, nb, skip));
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int ct = threadIdx.x, wg = ct / 128, t = ct % 128, lane = t & 31, q = lane & 3;
    const bool elected = t == 0;
    unsigned char* act_p = sm.base + kBwdStages * kSlotBytes;
    unsigned char* enc_p = act_p + kActBytes;
    uint32_t* masks = reinterpret_cast<uint32_t*>(enc_p + kEncBytes);
    float* staging = reinterpret_cast<float*>(enc_p + kEncBytes + kMaskBytes) + wg * 4 * 256;
    const bf16* w_alpha = weights + (size_t)total_slots * 64 * W;
    const int x_cols = 1 + (layers - 1) * nb, g_cols = layers * nb;
    const int tp_ld = layers * W + W + 1;
    float* tp = tile_part + ((size_t)blockIdx.x * 2 + wg) * tp_ld;
    float acc[W / 2];

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile * kTile;
      const size_t pblock = (size_t)tile * 2 + wg;
      const bool first = tile == (int)blockIdx.x;

      // Recompute the forward; X <- the encodings and every layer's input.
      if (elected) bulk_wait_read();
      named_sync(1 + wg, 128);
      load_encoding(encoded, enc_p, wg, row0, n_points, pe, t);
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (elected) {
        bulk_store(x_scr + pblock * x_cols * kBlock, enc + wg * 64 * 128, 8192);
        bulk_commit();
      }
      for (int i = 0; i < layers; ++i) {
        forward_layer<W, kBwdStages>(acc, ring, i, skip, act, enc, wg, lane);
        bias_relu<W>(acc, biases + i * W, t);
#pragma unroll
        for (int w = 0; w < W / 64; ++w) {
          uint32_t m = 0;
#pragma unroll
          for (int b = 0; b < 32; ++b) m |= (acc[32 * w + b] > 0.0f ? 1u : 0u) << b;
          masks[(i * 4 + w) * kConsumers + ct] = m;
        }
        if (i + 1 < layers) {
          if (elected) bulk_wait_read();
          named_sync(1 + wg, 128);
          store_tile<W>(act_p, acc, wg, t);
          fence_async_smem();
          named_sync(1 + wg, 128);
          if (elected) {
            for (int j = 0; j < nb; ++j)
              bulk_store(x_scr + (pblock * x_cols + 1 + i * nb + j) * kBlock, act + (j * kTile + wg * 64) * 128,
                         8192);
            bulk_commit();
          }
        }
      }

      // Alpha head: dW_alpha partial = bf16(h)^T bf16(g_alpha), db_alpha = sum g_alpha.
      const int r0 = row0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);
      const float ga0 = r0 < n_points ? g_alpha[r0] : 0.0f;
      const float ga1 = r0 + 8 < n_points ? g_alpha[r0 + 8] : 0.0f;
      const float gb0 = __bfloat162float(__float2bfloat16(ga0)), gb1 = __bfloat162float(__float2bfloat16(ga1));
#pragma unroll
      for (int v = 0; v < W / 2; ++v)
        acc[v] = __bfloat162float(__float2bfloat16(acc[v])) * ((v & 2) ? gb1 : gb0);
      column_sums<W>(acc, staging, tp + layers * W, wg, t, first);
      if (elected) {
        float s = 0.0f;
        for (int r = row0 + 64 * wg; r < row0 + 64 * wg + 64; ++r) s += r < n_points ? g_alpha[r] : 0.0f;
        tp[layers * W + W] = first ? s : tp[layers * W + W] + s;
      }
      // g = g_h + bf16(g_alpha) bf16(w_alpha)^T.
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float wa0 = __bfloat162float(w_alpha[col]), wa1 = __bfloat162float(w_alpha[col + 1]);
        const float2 h0 = r0 < n_points ? *reinterpret_cast<const float2*>(g_h + (size_t)r0 * W + col)
                                        : make_float2(0.0f, 0.0f);
        const float2 h1 = r0 + 8 < n_points ? *reinterpret_cast<const float2*>(g_h + (size_t)(r0 + 8) * W + col)
                                            : make_float2(0.0f, 0.0f);
        acc[4 * j] = h0.x + gb0 * wa0;
        acc[4 * j + 1] = h0.y + gb0 * wa1;
        acc[4 * j + 2] = h1.x + gb1 * wa0;
        acc[4 * j + 3] = h1.y + gb1 * wa1;
      }
      for (int i = layers - 1; i >= 0; --i) {
#pragma unroll
        for (int w = 0; w < W / 64; ++w) {
          const uint32_t m = masks[(i * 4 + w) * kConsumers + ct];
#pragma unroll
          for (int b = 0; b < 32; ++b) acc[32 * w + b] = ((m >> b) & 1u) ? acc[32 * w + b] : 0.0f;
        }
        column_sums<W>(acc, staging, tp + i * W, wg, t, first);
        if (elected) bulk_wait_read();
        named_sync(1 + wg, 128);
        store_tile<W>(act_p, acc, wg, t);
        fence_async_smem();
        named_sync(1 + wg, 128);
        if (elected) {
          for (int j = 0; j < nb; ++j)
            bulk_store(g_scr + (pblock * g_cols + i * nb + j) * kBlock, act + (j * kTile + wg * 64) * 128, 8192);
          bulk_commit();
        }
        // g_in = bf16(g) @ bf16(W_i)^T. The encoding slot comes first: its 64
        // columns, a term of d_encoded, form in acc's first 32 registers (g
        // is in the tile by now) and go to d_encoded, layer 0's added to the
        // skip layer's in place. Then h slot j gives columns 64 j .. 64 j + 63
        // of the next g.
        int prev = -1;
        if (i == 0 || i == skip) {
          backward_slot<W, kBwdStages>(acc, ring, prev, act, wg, lane, false);
          release_last(ring, prev, lane);
          fence_regs<32>(acc);
          prev = -1;
          const bool add = i == 0 && skip < layers;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int point = r0 + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
              float* d = d_encoded + (size_t)point * pe + col;
              if (point < n_points && col < pe) *d = add ? *d + acc[4 * j + e] : acc[4 * j + e];
            }
        }
        if (i > 0) {
#pragma unroll
          for (int j = 0; j < nb; ++j) backward_slot<W, kBwdStages>(acc + 32 * j, ring, prev, act, wg, lane, false);
          release_last(ring, prev, lane);
          fence_regs<W / 2>(acc);
        }
      }
    }
    if (elected) bulk_wait();
  }
}

// dW for output tile blockIdx.x (two 64-row blocks of the padded weight-
// gradient rows, one per consumer warpgroup; the last tile of a layer may
// have one) over the point blocks of chunk blockIdx.y: partial[chunk, rows]
// = X_in^T G over those points. A = X^T and B = G, both MN-major.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    backbone_dw_kernel(const bf16* __restrict__ x_scr, const bf16* __restrict__ g_scr, float* __restrict__ partial,
                       int point_blocks, int chunks, int rows_pad, int layers, int skip) {
  constexpr int nb = W / 64;
  // Which layer, and which of its row blocks, this tile covers.
  int layer = 0, pair = blockIdx.x, row_start = 0;
  for (;;) {
    const int blocks = layer == 0 ? 1 : nb + (layer == skip);
    if (pair < (blocks + 1) / 2) break;
    pair -= (blocks + 1) / 2;
    row_start += 64 * blocks;
    ++layer;
  }
  const int blocks = layer == 0 ? 1 : nb + (layer == skip);
  const int n_blk = min(2, blocks - 2 * pair);
  auto x_column = [&](int b) { return (layer == 0 || b == nb) ? 0 : 1 + (layer - 1) * nb + b; };
  const int x_cols = 1 + (layers - 1) * nb, g_cols = layers * nb;
  const int p0 = (int)((long long)blockIdx.y * point_blocks / chunks);
  const int p1 = (int)((long long)(blockIdx.y + 1) * point_blocks / chunks);

  extern __shared__ unsigned char smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const uint32_t bars = sm.addr + kDwStages * kDwStageBytes;
  const uint32_t full = bars, empty = bars + 8 * kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * n_blk);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int stage = 0, phase = 0;
      const uint32_t bytes = 8192 * (n_blk + nb);
      for (int p = p0; p < p1; ++p) {
        const uint32_t s = sm.addr + stage * kDwStageBytes;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, bytes);
        for (int b = 0; b < n_blk; ++b)
          bulk_load(s + 8192 * b, x_scr + ((size_t)p * x_cols + x_column(2 * pair + b)) * kBlock, 8192,
                    full + 8 * stage);
        bulk_load(s + 16384, g_scr + ((size_t)p * g_cols + layer * nb) * kBlock, 8192 * nb, full + 8 * stage);
        if (++stage == kDwStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t & 31, q = lane & 3;
    if (wg < n_blk) {
      float acc[W / 2];
      int stage = 0, phase = 0, prev = -1;
      for (int p = p0; p < p1; ++p) {
        const uint32_t s = sm.addr + stage * kDwStageBytes;
        mbar_wait(full + 8 * stage, phase);
        wgmma_fence();
        const uint64_t da = sw128_base(s + 8192 * wg, 8192, 1024), db = sw128_base(s + 16384, 8192, 1024);
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma<W, 1, 1>(acc, da + 128 * k, db + 128 * k, (p > p0 || k > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kDwStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<W / 2>(acc);
      const int r = row_start + 128 * pair + 64 * wg + 16 * (t >> 5) + (lane >> 2);
      float* out = partial + ((size_t)blockIdx.y * rows_pad + r) * W;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int col = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(out + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(out + 8 * W + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// out[e] = sum over chunks of partial (e < dw_elems), then sum over the
// tile kernel's rows of tile_part; each sum in index order.
__global__ void backbone_grad_reduce_kernel(const float* __restrict__ partial, int chunks, size_t dw_elems,
                                            const float* __restrict__ tile_part, int rows, int tp_ld,
                                            float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < dw_elems) {
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * dw_elems + e];
    out[e] = s;
  } else if (e < dw_elems + tp_ld) {
    const size_t j = e - dw_elems;
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += tile_part[(size_t)r * tp_ld + j];
    out[e] = s;
  }
}

// ---- host side -------------------------------------------------------------------

int dw_tiles(int width, int layers, int skip) {
  const int nb = width / 64;
  int tiles = 0;
  for (int i = 0; i < layers; ++i) tiles += ((i == 0 ? 1 : nb + (i == skip)) + 1) / 2;
  return tiles;
}

int rows_padded(int width, int layers, int skip) {
  int rows = 0;
  for (int i = 0; i < layers; ++i) rows += i == 0 ? kPe : (i == skip ? width + kPe : width);
  return rows;
}

// Raises the dynamic shared-memory limit of width W's kernels, once per
// process and device (the current one, on which the kernels launch).
template <int W>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(backbone_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(backbone_bwd_tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kBwdSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(backbone_dw_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  done[device] = e == cudaSuccess;
  return e;
}

template <int W>
int fwd_launch(const void* encoded, const void* weights, const void* biases, void* h_out, void* alpha_out,
               int n_points, int pe, int layers, int skip, int grid, cudaStream_t stream) {
  cudaError_t err = prepare<W>();
  if (err != cudaSuccess) return (int)err;
  backbone_fwd_kernel<W><<<grid, kThreads, kFwdSmem, stream>>>(
      (const float*)encoded, (const bf16*)weights, (const float*)biases, (float*)h_out, (float*)alpha_out,
      n_points, pe, layers, skip);
  return (int)cudaGetLastError();
}

// With `ms`, records CUDA events around the three launches, waits for them
// and writes each one's milliseconds to ms[0..2].
template <int W>
int bwd_launch(const void* encoded, const void* g_h, const void* g_alpha, const void* weights, const void* biases,
               void* d_encoded, void* x_scr, void* g_scr, void* tile_part, void* partial, void* grads_out,
               int n_points, int pe, int layers, int skip, int grid, int chunks, cudaStream_t stream, float* ms) {
  cudaError_t err = prepare<W>();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n_points + kTile - 1) / kTile;
  const int rows_pad = rows_padded(W, layers, skip);
  const int tp_ld = layers * W + W + 1;
  cudaEvent_t events[4];
  if (ms != nullptr) {
    for (int i = 0; i < 4; ++i) cudaEventCreate(&events[i]);
    cudaEventRecord(events[0], stream);
  }

  backbone_bwd_tile_kernel<W><<<grid, kThreads, kBwdSmem, stream>>>(
      (const bf16*)encoded, (const float*)g_h, (const float*)g_alpha, (const bf16*)weights,
      (const float*)biases, (float*)d_encoded, (bf16*)x_scr, (bf16*)g_scr, (float*)tile_part, n_points, pe, layers,
      skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ms != nullptr) cudaEventRecord(events[1], stream);

  backbone_dw_kernel<W><<<dim3(dw_tiles(W, layers, skip), chunks), kThreads, kDwSmem, stream>>>(
      (const bf16*)x_scr, (const bf16*)g_scr, (float*)partial, 2 * tiles, chunks, rows_pad, layers, skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ms != nullptr) cudaEventRecord(events[2], stream);

  const size_t dw_elems = (size_t)rows_pad * W;
  const size_t total = dw_elems + tp_ld;
  backbone_grad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, chunks, dw_elems, (const float*)tile_part, 2 * grid, tp_ld, (float*)grads_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || ms == nullptr) return (int)err;
  cudaEventRecord(events[3], stream);
  err = cudaEventSynchronize(events[3]);
  for (int i = 0; i < 3; ++i) cudaEventElapsedTime(&ms[i], events[i], events[i + 1]);
  for (int i = 0; i < 4; ++i) cudaEventDestroy(events[i]);
  return (int)err;
}

}  // namespace

// Each launcher runs on `stream` with `grid` CTAs (min(tiles, SMs), tiles =
// ceil(N / 128)) and returns the CUDA error code (0 on success). Shapes and
// limits (width in {64, 128, 192, 256}, pe <= 64, layers <= 8, skip != 0),
// the grid and the scratch sizes are decided by the Python wrapper
// (ops/fused_nerf.py), which allocates every buffer.
extern "C" int fused_backbone_fwd_launch(const void* encoded, const void* weights, const void* biases, void* h_out,
                                         void* alpha_out, int n_points, int pe, int width, int layers, int skip,
                                         int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FWD(W) fwd_launch<W>(encoded, weights, biases, h_out, alpha_out, n_points, pe, layers, skip, grid, s)
  switch (width) {
    case 64: return FWD(64);
    case 128: return FWD(128);
    case 192: return FWD(192);
    case 256: return FWD(256);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// encoded: (N, pe) bf16. Scratch: x_scr bf16 (2 tiles, 1 + (L-1) W/64, 64,
// 64); g_scr bf16 (2 tiles, L W/64, 64, 64); tile_part f32 (2 grid, L W + W
// + 1); partial f32 (chunks, rows_pad, W), chunks <= 2 tiles.
// grads_out f32: (rows_pad, W) weight gradients in the padded row order,
// then db_0 .. db_{L-1}, dW_alpha (W), db_alpha (1). ms: null, or 3 floats
// that receive the three kernels' times (the call then waits for them).
extern "C" int fused_backbone_bwd_launch(const void* encoded, const void* g_h, const void* g_alpha,
                                         const void* weights, const void* biases, void* d_encoded, void* x_scr,
                                         void* g_scr, void* tile_part, void* partial, void* grads_out, int n_points,
                                         int pe, int width, int layers, int skip, int grid, int chunks, void* stream,
                                         float* ms) {
  cudaStream_t s = (cudaStream_t)stream;
#define BWD(W)                                                                                                      \
  bwd_launch<W>(encoded, g_h, g_alpha, weights, biases, d_encoded, x_scr, g_scr, tile_part, partial, grads_out, \
                n_points, pe, layers, skip, grid, chunks, s, ms)
  switch (width) {
    case 64: return BWD(64);
    case 128: return BWD(128);
    case 192: return BWD(192);
    case 256: return BWD(256);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
