// Trainable fused NeRF backbone for Hopper (sm_90a) in f32: forward and
// backward with f32 operands and f32 sums, every product on the tensor cores
// as three TF32 wgmma products (3xTF32).
//
// Replaces the TPU kernels playableenvironments_tpu/ops/fused_nerf.py::
// _fwd_backbone_kernel and _bwd_backbone_kernel run with compute_dtype
// float32 (every product's `mm` dtype f32): the L-layer, W-wide ReLU backbone
// over the positional encoding, the encoding concatenated back in at `skip`,
// plus the alpha head alpha = h . w_alpha + b_alpha, and its backward
// (recompute, dX, dW, db). csrc/fused_backbone.cu is the bf16 version.
//
// Bound: at the tennis widths (W 256, 8 layers, encoding 63) a point costs
// 491,264 MAC forward and three times that backward, the backward recomputing
// the forward as the TPU kernel does. At the card's FP32 rate outside the
// tensor cores (67 TFLOP/s) that bound sits near cuBLAS's f32 chain, so the
// products run on the tensor cores instead: TF32 wgmma (494.7 TFLOP/s dense)
// three times a multiply-add keeps f32 accuracy at an effective 165 TFLOP/s.
//
// 3xTF32: each f32 operand x splits into big = x rounded to TF32 (cvt.rna)
// and small = x - big, rounded the same way; a product is small·big +
// big·small + big·big, the two small terms issued first. What is left out
// (small·small, the rounding of small) is below 2^-21 of a product. The
// tensor cores truncate each sum they accumulate, so the products of two
// k-steps go into a fresh accumulator that is then added into f32 registers
// that round to nearest (accumulating a whole layer in the tensor cores
// drifted enough to flip ReLUs). TF32 wgmma reads both operands
// K-major and no transpose exists for it, which sets every layout below.
//
// A operands come from registers. A layer's output, in wgmma's accumulator
// layout (thread t of a warpgroup: rows g = (t % 32) / 4 + 16 (t / 32) and
// g + 8, columns 8 j + 2 q + {0, 1} with q = t % 4), is the A fragment of
// the next layer's k-step j (rows g, g + 8; k = q, q + 4) once the columns
// of each 8-column step are taken in the order pi(k) = 2 (k % 4) + k / 4.
// Each thread parks its fragments between layers in 16-byte slots of shared
// memory ("staging", one float4 a k-step, conflict-free) and splits them
// into big and small in registers as it feeds them. The weight images
// permute their K axis by pi to match; the encoding is loaded in that order.
//
// Weight images (built on the card by backbone_f32_pack_kernel, one launch,
// from the packed weights; ops/fused_nerf.py::plain_backbone_f32_buffers is
// its plain version): f32, in slots of one k-step (8 K rows) by N columns.
// A slot is 2 x N x 8 floats: big, then small, each in wgmma's layout
// without swizzle (K-major core matrices of 8 N rows x 4 K floats, 128
// bytes; the two of a k-step 128 bytes apart, groups of 8 N rows 256 bytes
// apart), so that one bulk copy lands it ready to use. Layer i's padded
// input rows (the encoding's zero-padded to 64; at the skip layer W
// activation rows then 64 encoding rows) are its K.
// - `fwd` (B = W_i^T, N = W output columns): layer i's in_i / 8 slots.
// - `bwd` (B = W_i, N = input rows, K = the W output columns): at layer 0
//   and the skip layer first W / 8 slots of the 64 encoding rows, then
//   (layers > 0) W / 8 slots of the W activation rows.
// Layer i starts at float 2 W (rows of the layers before it) in both.
// Biases and w_alpha are f32 copies beside them.
//
// The tile kernels: a 64-point tile a CTA at a time, persistent; one
// producer warp (one thread issues) streams the slots of every layer
// through a ring of 4 slots (bulk copies on mbarriers); two consumer
// warpgroups take the tile's 64 rows each, warpgroup w the output columns
// [w W / 2, (w + 1) W / 2) of every product (m64n(W/2)k8). A layer's
// output is staged by both for both (two staging buffers by turns, one
// barrier of the 256 consumer threads a layer). A thread keeps the RN sums
// (W / 4 floats) and one tensor-core accumulator (W / 4): ptxas allots 168
// registers a thread when 3 warps share an SM sub-partition, which a second
// accumulator would exceed. Shared memory at W = 256: the ring (64 KB), two
// staging buffers of 64 points x W (128 KB), the encoding's (16 KB): 209
// KB of the 227 KB a CTA may have.
//
// Forward (backbone_f32_fwd_kernel): bias and ReLU on the sums; h goes out
// from registers; the alpha head is an f32 quad-shuffle dot product, the
// second warpgroup's half added to the first's through shared memory.
//
// Backward, three kernels, every sum in a fixed order (no atomics on global
// memory), bit-identical from launch to launch:
// 1. backbone_f32_bwd_tile_kernel, persistent like the forward: recomputes
//    it, keeping each layer's ReLU mask as bits in a global scratch of its
//    own (L2-resident, read back by the same thread) and storing each
//    layer's input X; back-propagates: masks g, stores G, adds db and the
//    alpha head's partials as fixed-order column sums into its warpgroup's
//    row of `tile_part`, and forms g @ W_i^T (the encoding rows first, into
//    d_encoded). X and G go to their scratch transposed: feature-major, in
//    blocks of 32 points whose 128-byte feature rows have their 16-byte
//    chunks XOR-ed with the feature index % 8 (wgmma's 128-byte swizzle with
//    the points as K), straight from the sums (each warp store fills whole
//    32-byte sectors).
// 2. backbone_f32_dw_kernel: dW_i = X_i^T G_i for one row block (two
//    64-row halves of X features, one per consumer warpgroup, the table of
//    ops/fused_nerf.py::backbone_f32_row_blocks) by NB = min(W, 128) output
//    columns, over one split of a chunk's points. A producer streams X and G
//    blocks of 32 points through a 4-stage ring; the consumers split G in
//    shared memory (big in place, small beside it), X in registers; each
//    block's products are added into RN sums. Added into the split's f32
//    slab.
// 3. backbone_f32_grad_reduce_kernel: sums the slabs over splits and the
//    tile kernel's rows, each in index order (the wide kernels leave db_alpha
//    at 0 there; backbone_f32_alpha_bias_kernel writes it from g_alpha).
// The launcher walks the points in chunks of `chunk_tiles` tiles (1,024,
// ops/fused_nerf.py::_F32_CHUNK_TILES) so that the X and G scratch stay
// bounded, ~1 GB at the tennis widths (backbone_f32_scratch_shapes); the
// slabs and the column-sum rows accumulate across chunks in place.
//
// Times on the card and what they are held against: PERF.md (chip_smoke.py
// phase 14a).

#include "nerf_wgmma.cuh"

namespace {

constexpr int kMaxLayers = 16;  // the weight pointers of one pack launch (a deeper network takes several)
constexpr int kPoints = 64;                 // points a tile: one m64 block, both warpgroups' rows
constexpr int kStages = 4;
constexpr int kStageBytes = 64 * 256;       // a slot of N = 256: 2 x 256 x 8 floats
constexpr int kStepBytes = 128 * 16;        // one k-step of A fragments, a float4 per thread of a warpgroup
constexpr int kMaskWords = 2;               // a thread's ReLU bits a layer (W / 4 of them)
// Two consumer warpgroups and one producer warp, one thread of which issues
// the copies (no setmaxnreg: the consumers fit the 168 registers a thread
// that ptxas allots where 3 warps share an SM sub-partition).
constexpr int kF32Threads = kConsumers + 32;
constexpr int kEncSteps = kPe / 8;
constexpr int kDwStages = 4;
constexpr int kXBytes = 64 * 128;           // 64 X features x 32 points

__host__ __device__ constexpr int in_pad(int i, int W, int skip) {
  return i == 0 ? kPe : (i == skip ? W + kPe : W);
}

__host__ __device__ inline int rows_before(int layer, int W, int skip) {
  int rows = 0;
  for (int i = 0; i < layer; ++i) rows += in_pad(i, W, skip);
  return rows;
}

// The same with the encoding's rows padded to pe_pad (64 or 128): the pack
// kernel's and the wide kernels'.
__host__ __device__ constexpr int in_pad_pe(int i, int W, int skip, int pe_pad) {
  return i == 0 ? pe_pad : (i == skip ? W + pe_pad : W);
}

__host__ __device__ inline int rows_before_pe(int layer, int W, int skip, int pe_pad) {
  int rows = 0;
  for (int i = 0; i < layer; ++i) rows += in_pad_pe(i, W, skip, pe_pad);
  return rows;
}

template <int W>
__host__ __device__ constexpr size_t tile_smem() {
  return 1024 + (size_t)kStages * kStageBytes + (size_t)(2 * (W / 8) + kEncSteps) * kStepBytes + 4 * kPoints +
         16 * kStages;
}

template <int NB>
__host__ __device__ constexpr size_t dw_stage_bytes() {
  return 2 * kXBytes + 2 * NB * 128;
}

template <int NB>
__host__ __device__ constexpr size_t dw_smem() {
  return 1024 + (size_t)kDwStages * dw_stage_bytes<NB>() + 16 * kDwStages;
}

// ---- 3xTF32 ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small: big rounded to TF32 (nearest, ties away), small the rest
// rounded the same way.
__device__ __forceinline__ void split4(const float4 x, uint32_t* big, uint32_t* small) {
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = tf32_rna(v[e]);
    small[e] = tf32_rna(v[e] - __uint_as_float(big[e]));
  }
}

// Descriptor of a K-major operand without swizzle: core matrices of 8 rows x
// 16 bytes, the two of a k-step 128 bytes apart, groups of 8 rows 256 apart.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// m64nNk8 tf32 x tf32 -> f32, A (4 registers, rows g and g + 8, k = q and
// q + 4) from registers, B from shared memory; the accumulator as in
// nerf_wgmma.cuh's wgmma.
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32) wgmma_tf32_n32(d, a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_tf32_n64(d, a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_tf32_n128(d, a, desc_b, scale_d);
}

// acc (+)= A B over one k-step in 3xTF32, the small terms first.
template <int N>
__device__ __forceinline__ void mma3(float* acc, const uint32_t* big, const uint32_t* small, uint64_t b_big,
                                     uint64_t b_small, int scale_d) {
  wgmma_tf32<N>(acc, small, b_big, scale_d);
  wgmma_tf32<N>(acc, big, b_small, 1);
  wgmma_tf32<N>(acc, big, b_big, 1);
}

template <int N>
__device__ __forceinline__ void add_to(float* sum, float* acc) {
  fence_regs<N>(acc);
#pragma unroll
  for (int v = 0; v < N; ++v) sum[v] += acc[v];
}

template <int N>
__device__ __forceinline__ void zero(float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.0f;
}

// Both consumer warpgroups (the producer never joins).
__device__ __forceinline__ void consumer_sync() { named_sync(3, kConsumers); }

// ---- the weight ring ------------------------------------------------------------

// Producer: `bytes` (at most kStage, the ring's stride) from `src` into the
// next slot once every consumer warp has released it.
template <int kStage = kStageBytes>
__device__ __forceinline__ void produce(Ring& r, const float* src, uint32_t bytes) {
  mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1);
  mbar_expect_tx(r.full + 8 * r.stage, bytes);
  bulk_load(r.slots + r.stage * kStage, src, bytes, r.full + 8 * r.stage);
  ring_advance<kStages>(r);
}

// Consumer: waits for the next slot and issues its three products for the
// warpgroup's H columns (rows n_off / 32 .. of the slot's n_all) into acc,
// fresh or added to.
template <int H, int kStage = kStageBytes>
__device__ __forceinline__ void issue(float* acc, Ring& r, const uint32_t* big, const uint32_t* small,
                                      uint32_t n_off, int n_all, int scale_d) {
  mbar_wait(r.full + 8 * r.stage, r.phase);
  wgmma_fence();
  const uint32_t slot = r.slots + r.stage * kStage + n_off;
  mma3<H>(acc, big, small, plain_desc(slot), plain_desc(slot + n_all * 32), scale_d);
  ring_advance<kStages>(r);
}

// sum += A B over `steps` slots for the warpgroup's H columns, A's k-step s
// the thread's fragment a[128 s] in the staging. Two slots' products go
// into a fresh accumulator and then into `sum`: the tensor cores truncate
// every sum they accumulate, which over a layer's 120 products drifts
// enough to flip ReLUs, while `sum` rounds to nearest.
template <int H, int kStage = kStageBytes>
__device__ __forceinline__ void product(float* sum, Ring& r, const float4* a, int steps, uint32_t n_off, int n_all,
                                        int lane) {
  float acc[H / 2];
  float4 next = a[0];
  for (int s = 0; s < steps; s += 2) {
    uint32_t big0[4], small0[4], big1[4], small1[4];
    split4(next, big0, small0);
    split4(a[128 * (s + 1)], big1, small1);
    if (s + 2 < steps) next = a[128 * (s + 2)];
    const int first = r.stage;
    issue<H, kStage>(acc, r, big0, small0, n_off, n_all, 0);
    issue<H, kStage>(acc, r, big1, small1, n_off, n_all, 1);
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(r.empty + 8 * first);
      mbar_arrive(r.empty + 8 * ((first + 1) % kStages));
    }
    add_to<H / 2>(sum, acc);
  }
}

// One forward layer for the warpgroup's H = W / 2 columns of the tile's 64
// points: sum = A_i @ W_i, A the activation staging (act) or the
// encoding's (enc), the layer's slots in image order.
template <int W>
__device__ __forceinline__ void forward_layer_f32(float* sum, Ring& r, int i, int skip, const float4* act,
                                                  const float4* enc, int wg, int lane) {
  constexpr int H = W / 2;
  zero<H / 2>(sum);
  if (i == 0) {
    product<H>(sum, r, enc, kEncSteps, wg * H * 32, W, lane);
  } else {
    product<H>(sum, r, act, W / 8, wg * H * 32, W, lane);
    if (i == skip) product<H>(sum, r, enc, kEncSteps, wg * H * 32, W, lane);
  }
}

// The thread's accumulator-layout values v (N columns) as A fragments into
// its staging slots: k-step j <- (v[4j], v[4j + 2], v[4j + 1], v[4j + 3]).
template <int N>
__device__ __forceinline__ void stage_fragments(float4* dst, const float* v) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) dst[128 * j] = make_float4(v[4 * j], v[4 * j + 2], v[4 * j + 1], v[4 * j + 3]);
}

// The thread's encodings of k-steps kk0 .. kk0 + KS - 1 in accumulator
// layout: v[4 kk + e] = encoded[point + 8 (e / 2)][8 (kk0 + kk) + 2 q + e %
// 2], zero outside [0, n) x [0, pe).
template <int KS>
__device__ __forceinline__ void load_encoding_f32(float* v, const float* __restrict__ encoded, int point, int n,
                                                  int pe, int q, int kk0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = point + 8 * (e >> 1), col = 8 * (kk0 + kk) + 2 * q + (e & 1);
      v[4 * kk + e] = (p < n && col < pe) ? __ldg(encoded + (size_t)p * pe + col) : 0.0f;
    }
}

// Accumulator-layout values v (N columns: features f0 + column) of rows
// `row` and row + 8 (of the chunk) into a feature-major scratch of `feats`
// features: point block row / 32, feature f's 128-byte row, 16-byte chunk
// (row % 32) / 4 XOR-ed with f % 8.
template <int N>
__device__ __forceinline__ void store_transposed(float* __restrict__ scr, int feats, int f0, const float* v, int row,
                                                 int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h, c = r & 31;
    float* block = scr + (size_t)(r >> 5) * feats * 32;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = f0 + 8 * j + 2 * q + e;
        block[(size_t)f * 32 + ((((c >> 2) ^ (f & 7)) << 2) | (c & 3))] = v[4 * j + 2 * h + e];
      }
  }
}

struct TileSmem {
  Smem sm;
  float4* act[2];  // staging of a layer's input, by turns: [W / 8 k-steps][128 threads]
  float4* enc;     // the encoding's: [8 k-steps][128 threads]
  float* alpha;    // the second warpgroup's alpha partials, 64
  uint32_t bars;
};

template <int W>
__device__ __forceinline__ TileSmem tile_smem_layout(unsigned char* raw) {
  TileSmem s;
  s.sm = aligned_smem(raw);
  s.act[0] = reinterpret_cast<float4*>(s.sm.base + kStages * kStageBytes);
  s.act[1] = s.act[0] + (W / 8) * 128;
  s.enc = s.act[1] + (W / 8) * 128;
  s.alpha = reinterpret_cast<float*>(s.enc + kEncSteps * 128);
  s.bars = s.sm.addr + kStages * kStageBytes + (2 * (W / 8) + kEncSteps) * kStepBytes + 4 * kPoints;
  return s;
}

__device__ __forceinline__ int fwd_slots(int W, int layers, int skip) { return rows_before(layers, W, skip) / 8; }

// Every tile: the warpgroup's 4 k-steps of the encoding (32 features from
// 32 wg) into the shared staging, between two barriers: the tile before is
// done with the staging, and the whole encoding is in place.
template <int W>
__device__ __forceinline__ void stage_encoding(const TileSmem& sm, const float* __restrict__ encoded, int point, int n,
                                               int pe, int wg, int t, int q, float* x_scr = nullptr, int x_feats = 0,
                                               int row = 0) {
  consumer_sync();
  float v[16];
  load_encoding_f32<4>(v, encoded, point, n, pe, q, 4 * wg);
  stage_fragments<32>(sm.enc + 4 * wg * 128 + t, v);
  if (x_scr != nullptr) store_transposed<32>(x_scr, x_feats, 32 * wg, v, row, q);
  consumer_sync();
}

// ---- B2 for f32 operands -------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kF32Threads, 1)
    backbone_f32_fwd_kernel(const float* __restrict__ encoded, const float* __restrict__ image,
                            const float* __restrict__ biases, const float* __restrict__ w_alpha,
                            float* __restrict__ h_out, float* __restrict__ alpha_out, int n, int pe, int layers,
                            int skip) {
  constexpr int H = W / 2;
  extern __shared__ unsigned char smem_raw[];
  const TileSmem sm = tile_smem_layout<W>(smem_raw);
  Ring ring;
  init_ring(ring, sm.sm.addr, sm.bars, kStages, 8);
  const int tiles = (n + kPoints - 1) / kPoints;
  const int slots = fwd_slots(W, layers, skip);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int s = 0; s < slots; ++s) produce(ring, image + (size_t)s * 16 * W, 64 * W);
  } else {
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t & 31, q = lane & 3, g = lane >> 2;
    const float b_alpha = __ldg(biases + layers * W);
    float sum[H / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = tile * kPoints + 16 * (t >> 5) + g;
      stage_encoding<W>(sm, encoded, r0, n, pe, wg, t, q);
      for (int i = 0; i < layers; ++i) {
        forward_layer_f32<W>(sum, ring, i, skip, sm.act[i & 1] + t, sm.enc + t, wg, lane);
        bias_relu<H>(sum, biases + i * W + wg * H, t);
        if (i + 1 < layers) {
          stage_fragments<H>(sm.act[(i + 1) & 1] + wg * (H / 8) * 128 + t, sum);
          consumer_sync();
        }
      }
      // h, and alpha = h . w_alpha + b_alpha in f32: each warpgroup's half,
      // the second's added to the first's.
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = wg * H + 8 * j + 2 * q;
        const float2 wa = __ldg(reinterpret_cast<const float2*>(w_alpha + col));
        s0 = fmaf(sum[4 * j + 1], wa.y, fmaf(sum[4 * j], wa.x, s0));
        s1 = fmaf(sum[4 * j + 3], wa.y, fmaf(sum[4 * j + 2], wa.x, s1));
        if (r0 < n) *reinterpret_cast<float2*>(h_out + (size_t)r0 * W + col) = make_float2(sum[4 * j], sum[4 * j + 1]);
        if (r0 + 8 < n)
          *reinterpret_cast<float2*>(h_out + (size_t)(r0 + 8) * W + col) = make_float2(sum[4 * j + 2], sum[4 * j + 3]);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const int row = 16 * (t >> 5) + g;
      if (wg == 1 && q == 0) {
        sm.alpha[row] = s0;
        sm.alpha[row + 8] = s1;
      }
      consumer_sync();
      if (wg == 0 && q == 0) {
        if (r0 < n) alpha_out[r0] = (s0 + sm.alpha[row]) + b_alpha;
        if (r0 + 8 < n) alpha_out[r0 + 8] = (s1 + sm.alpha[row + 8]) + b_alpha;
      }
    }
  }
}

// ---- B3 for f32 operands ---------------------------------------------------------

struct BwdTileParams {
  const float* encoded;
  const float* g_h;
  const float* g_alpha;
  const float* fwd_image;
  const float* bwd_image;
  const float* biases;
  const float* w_alpha;
  float* d_encoded;
  float* x_scr;       // feature-major blocks of 32 points: the encoding, then activations 0 .. L-2
  float* g_scr;       // the same for G_0 .. G_{L-1}
  float* tile_part;   // (2 grid, L W + W + 1): db_0 .. db_{L-1}, dW_alpha, db_alpha per warpgroup
  uint32_t* masks;    // (grid, L, kMaskWords, 256) ReLU mask bits, each thread's own
  int n, pe, layers, skip;
  int first_tile;     // the chunk's first tile
  int tiles;          // tiles of the chunk
  int x_feats, g_feats;
};

template <int W>
__global__ void __launch_bounds__(kF32Threads, 1) backbone_f32_bwd_tile_kernel(const __grid_constant__ BwdTileParams p) {
  constexpr int H = W / 2;
  constexpr int kBits = H / 2 < 32 ? H / 2 : 32, kWords = H / 2 / kBits;
  extern __shared__ unsigned char smem_raw[];
  const TileSmem sm = tile_smem_layout<W>(smem_raw);
  Ring ring;
  init_ring(ring, sm.sm.addr, sm.bars, kStages, 8);
  const int L = p.layers, skip = p.skip;
  const int slots = fwd_slots(W, L, skip);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int s = 0; s < slots; ++s) produce(ring, p.fwd_image + (size_t)s * 16 * W, 64 * W);
        for (int i = L - 1; i >= 0; --i) {
          const float* src = p.bwd_image + 2 * (size_t)W * rows_before(i, W, skip);
          if (i == 0 || i == skip)
            for (int k = 0; k < W / 8; ++k, src += 16 * kPe) produce(ring, src, 64 * kPe);
          if (i > 0)
            for (int k = 0; k < W / 8; ++k, src += 16 * W) produce(ring, src, 64 * W);
        }
      }
    }
  } else {
    const int ct = threadIdx.x, wg = ct / 128, t = ct % 128, lane = t & 31, q = lane & 3, g = lane >> 2;
    // The column sums' staging: 4 KB of the encoding's for each warpgroup,
    // free once the recompute is done.
    float* staging = reinterpret_cast<float*>(sm.enc) + wg * 1024;
    const int tp_ld = L * W + W + 1;
    float* tp = p.tile_part + ((size_t)blockIdx.x * 2 + wg) * tp_ld;
    uint32_t* masks = p.masks + (size_t)blockIdx.x * L * kMaskWords * kConsumers + ct;
    float sum[H / 2];

    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int row = tile * kPoints + 16 * (t >> 5) + g;  // of the chunk
      const int r0 = p.first_tile * kPoints + row;         // the point
      stage_encoding<W>(sm, p.encoded, r0, p.n, p.pe, wg, t, q, p.x_scr, p.x_feats, row);
      // Recompute; X <- every layer's input, masks <- each layer's ReLU.
      for (int i = 0; i < L; ++i) {
        forward_layer_f32<W>(sum, ring, i, skip, sm.act[i & 1] + t, sm.enc + t, wg, lane);
        bias_relu<H>(sum, p.biases + i * W + wg * H, t);
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          uint32_t m = 0;
#pragma unroll
          for (int b = 0; b < kBits; ++b) m |= (sum[kBits * w + b] > 0.0f ? 1u : 0u) << b;
          masks[(i * kMaskWords + w) * kConsumers] = m;
        }
        if (i + 1 < L) {
          stage_fragments<H>(sm.act[(i + 1) & 1] + wg * (H / 8) * 128 + t, sum);
          store_transposed<H>(p.x_scr, p.x_feats, kPe + i * W + wg * H, sum, row, q);
        }
        consumer_sync();  // the staging is written; after the last layer, the encoding's is free
      }

      // The alpha head: dW_alpha += h^T g_alpha, db_alpha += sum g_alpha.
      const float ga0 = r0 < p.n ? p.g_alpha[r0] : 0.0f;
      const float ga1 = r0 + 8 < p.n ? p.g_alpha[r0 + 8] : 0.0f;
#pragma unroll
      for (int v = 0; v < H / 2; ++v) sum[v] *= (v & 2) ? ga1 : ga0;
      column_sums<H>(sum, staging, tp + L * W + wg * H, wg, t, false);
      if (ct == 0) {
        const int first = (p.first_tile + tile) * kPoints;
        double s = 0.0;
        for (int r = first; r < first + kPoints; ++r) s += r < p.n ? p.g_alpha[r] : 0.0f;
        tp[L * W + W] += (float)s;
      }
      // g = g_h + g_alpha w_alpha^T.
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = wg * H + 8 * j + 2 * q;
        const float2 wa = __ldg(reinterpret_cast<const float2*>(p.w_alpha + col));
        const float2 h0 = r0 < p.n ? *reinterpret_cast<const float2*>(p.g_h + (size_t)r0 * W + col)
                                   : make_float2(0.0f, 0.0f);
        const float2 h1 = r0 + 8 < p.n ? *reinterpret_cast<const float2*>(p.g_h + (size_t)(r0 + 8) * W + col)
                                       : make_float2(0.0f, 0.0f);
        sum[4 * j] = fmaf(ga0, wa.x, h0.x);
        sum[4 * j + 1] = fmaf(ga0, wa.y, h0.y);
        sum[4 * j + 2] = fmaf(ga1, wa.x, h1.x);
        sum[4 * j + 3] = fmaf(ga1, wa.y, h1.y);
      }
      int b = 0;
      for (int i = L - 1; i >= 0; --i, b ^= 1) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const uint32_t m = masks[(i * kMaskWords + w) * kConsumers];
#pragma unroll
          for (int k = 0; k < kBits; ++k) sum[kBits * w + k] = ((m >> k) & 1u) ? sum[kBits * w + k] : 0.0f;
        }
        store_transposed<H>(p.g_scr, p.g_feats, i * W + wg * H, sum, row, q);
        column_sums<H>(sum, staging, tp + i * W + wg * H, wg, t, false);
        stage_fragments<H>(sm.act[b] + wg * (H / 8) * 128 + t, sum);
        consumer_sync();
        // g_in = g @ W_i^T: the encoding rows first (32 of them a warpgroup,
        // a term of d_encoded, layer 0's added to the skip layer's), then
        // the activation rows, the next g.
        if (i == 0 || i == skip) {
          zero<kPe / 4>(sum);
          product<kPe / 2>(sum, ring, sm.act[b] + t, W / 8, wg * (kPe / 2) * 32, kPe, lane);
          const bool add = i == 0 && skip < L;
#pragma unroll
          for (int j = 0; j < kPe / 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int point = r0 + 8 * (e >> 1), col = wg * (kPe / 2) + 8 * j + 2 * q + (e & 1);
              float* d = p.d_encoded + (size_t)point * p.pe + col;
              if (point < p.n && col < p.pe) *d = add ? *d + sum[4 * j + e] : sum[4 * j + e];
            }
        }
        if (i > 0) {
          zero<H / 2>(sum);
          product<H>(sum, ring, sm.act[b] + t, W / 8, wg * H * 32, W, lane);
        }
      }
    }
  }
}

// dW for one row block (blockIdx.x / col_blocks: two 64-row halves whose X
// features the table gives, -1 for none) and NB output columns (blockIdx.x
// % col_blocks), over point blocks [blockIdx.y per_split, ...) of the chunk:
// partial[blockIdx.y] += X^T G. A = X (features x points, K-major) from
// registers, B = G (columns x points, K-major, 128-byte swizzle) split in
// shared memory.
struct DwParams {
  const float* x_scr;
  const float* g_scr;
  const int* table;  // per row block: out_row, x feature of its first 64 rows, of its second or -1, layer
  float* partial;    // (splits, rows_pad, W)
  int blocks;        // 32-point blocks of the chunk
  int per_split;     // blocks a split
  int x_feats, g_feats, rows_pad, width;
};

template <int NB>
__global__ void __launch_bounds__(kF32Threads, 1) backbone_f32_dw_kernel(const __grid_constant__ DwParams p) {
  constexpr uint32_t kStage = dw_stage_bytes<NB>(), kG = NB * 128;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const int col_blocks = p.width / NB;
  const int rb = blockIdx.x / col_blocks, cb = blockIdx.x % col_blocks;
  const int out_row = p.table[4 * rb], layer = p.table[4 * rb + 3];
  const int xcol[2] = {p.table[4 * rb + 1], p.table[4 * rb + 2]};
  const int b0 = blockIdx.y * p.per_split, b1 = min(b0 + p.per_split, p.blocks);
  const uint32_t full = sm.addr + kDwStages * kStage, empty = full + 8 * kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int stage = 0, phase = 0;
      const uint32_t bytes = kXBytes * (xcol[1] >= 0 ? 2 : 1) + kG;
      for (int b = b0; b < b1; ++b) {
        const uint32_t s = sm.addr + stage * kStage;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, bytes);
        for (int h = 0; h < 2; ++h)
          if (xcol[h] >= 0)
            bulk_load(s + h * kXBytes, p.x_scr + ((size_t)b * p.x_feats + xcol[h]) * 32, kXBytes, full + 8 * stage);
        bulk_load(s + 2 * kXBytes, p.g_scr + ((size_t)b * p.g_feats + layer * p.width + cb * NB) * 32, kG,
                  full + 8 * stage);
        if (++stage == kDwStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    const int ct = threadIdx.x, wg = ct / 128, t = ct % 128, lane = t & 31, q = lane & 3;
    const int f = 16 * (t >> 5) + (lane >> 2);  // the thread's first X feature of the half
    const bool active = xcol[wg] >= 0;
    float sum[NB / 2], acc[NB / 2];
#pragma unroll
    for (int v = 0; v < NB / 2; ++v) sum[v] = 0.0f;
    int stage = 0, phase = 0;
    for (int b = b0; b < b1; ++b) {
      unsigned char* s = sm.base + stage * kStage;
      const uint32_t s_addr = sm.addr + stage * kStage;
      mbar_wait(full + 8 * stage, phase);
      // G -> big in place, small beside it.
      float4* g = reinterpret_cast<float4*>(s + 2 * kXBytes);
      float4* g_small = reinterpret_cast<float4*>(s + 2 * kXBytes + kG);
      for (int idx = ct; idx < NB * 8; idx += kConsumers) {
        uint32_t big[4], small[4];
        split4(g[idx], big, small);
        g[idx] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]), __uint_as_float(big[2]),
                             __uint_as_float(big[3]));
        g_small[idx] = make_float4(__uint_as_float(small[0]), __uint_as_float(small[1]), __uint_as_float(small[2]),
                                   __uint_as_float(small[3]));
      }
      fence_async_smem();
      named_sync(1, kConsumers);
      if (active) {
        const unsigned char* x = s + wg * kXBytes;
        uint32_t big[4][4], small[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ff = f + 8 * (e & 1), c = 8 * kk + q + 4 * (e >> 1);
            v[e] = *reinterpret_cast<const float*>(x + ff * 128 + ((((c >> 2) ^ (ff & 7)) << 4) | ((c & 3) << 2)));
          }
          split4(make_float4(v[0], v[1], v[2], v[3]), big[kk], small[kk]);
        }
        const uint32_t gb = s_addr + 2 * kXBytes, gs = gb + kG;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3<NB>(acc, big[kk], small[kk], sw128_desc(gb + 32 * kk, 16, 1024), sw128_desc(gs + 32 * kk, 16, 1024),
                   kk > 0 ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NB / 2>(acc);
#pragma unroll
        for (int v = 0; v < NB / 2; ++v) sum[v] += acc[v];
      }
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == kDwStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (active) {
      const int r = out_row + 64 * wg + f;
      float* out = p.partial + ((size_t)blockIdx.y * p.rows_pad + r) * p.width + cb * NB;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int col = 8 * j + 2 * q;
        float2* o0 = reinterpret_cast<float2*>(out + col);
        float2* o1 = reinterpret_cast<float2*>(out + (size_t)8 * p.width + col);
        const float2 a0 = *o0, a1 = *o1;
        *o0 = make_float2(a0.x + sum[4 * j], a0.y + sum[4 * j + 1]);
        *o1 = make_float2(a1.x + sum[4 * j + 2], a1.y + sum[4 * j + 3]);
      }
    }
  }
}

// grads_out[j] = sum over splits of partial[s][j] (the padded dW), then the
// tile kernel's rows summed for db, dW_alpha and db_alpha; each in order, in
// f64 (a bias gradient is a sum over every point, whose random signs leave
// it small beside its terms).
__global__ void backbone_f32_grad_reduce_kernel(const float* __restrict__ partial, int splits, size_t dw_elems,
                                                const float* __restrict__ tile_part, int rows, int tp_ld,
                                                float* __restrict__ out) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < dw_elems) {
    double s = 0.0;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * dw_elems + j];
    out[j] = (float)s;
  } else if (j < dw_elems + tp_ld) {
    const size_t c = j - dw_elems;
    double s = 0.0;
    for (int r = 0; r < rows; ++r) s += tile_part[(size_t)r * tp_ld + c];
    out[j] = (float)s;
  }
}

// ---- beyond the published shapes: the wide kernels -----------------------------
//
// Widths 256, 512 and 640 (a width above 256 zero-padded to the next of
// them), encodings of 65-256 columns, more than 8 layers (at W <= 256 run at
// W 256); depth is a runtime loop bound. Each layer runs in passes of NP
// columns (f32_pass: 256 at W 256 and 512, 128 at W 640, whose 640 columns
// are five such passes), warpgroup w computing columns [NP c + H w, NP c +
// H (w + 1)) of pass c, H = NP / 2, so that a thread keeps at most the sums
// and the tensor-core accumulator of the 256-wide kernel (168 registers).
// The layer's input stays in one staging buffer in shared memory until
// every pass has read it, so each pass's output fragments wait in a global
// scratch of the CTA's (`stash`, L2-resident, read back by the thread that
// wrote them) and go into the staging after a barrier. The encoding's
// fragments (8 ps k-steps) are staged in the same scratch past the layer's
// W / 8 k-steps and read from there by layer 0 and the skip layer: in shared
// memory they would not fit beside a 640-wide layer's 160 KB. Shared memory
// at W 640: the ring (4 stages of 64 NP bytes, 32 KB), the 160 KB staging of
// a layer's input, 8 KB of column-sum staging, the alpha partials: 201 KB of
// 227 (W 512: 201 KB too; W 256: 137 KB). Weight images as the 256-wide
// kernels' with each layer's slots in passes (fwd: pass c's k-steps of
// columns [NP c, NP c + NP); bwd: the encoding's 64-row groups, then the
// activation rows in groups of NP, each W / 8 k-steps), and the encoding's
// rows padded to 64 ps (ps = 1 to 4; pe_pad = 64 ps).

// The columns of one pass of a width-W layer: W up to 256, then 256, or
// 128 where 256 does not divide W.
__host__ __device__ constexpr int f32_pass(int W) { return W <= 256 ? W : (W % 256 == 0 ? 256 : 128); }

template <int W>
__host__ __device__ constexpr size_t wide_smem() {
  return 1024 + (size_t)kStages * 64 * f32_pass(W) + (size_t)(W / 8) * kStepBytes + 4 * kPoints +
         2 * 4 * 256 * 4 + 16 * kStages;
}

struct WideSmem {
  float4* act;     // the layer's input: [W / 8 k-steps][128 threads]
  float* alpha;    // the second warpgroup's alpha partials, 64
  float* staging;  // column sums: 4 warps x 256 floats a warpgroup
  uint32_t ring, bars;
};

template <int W>
__device__ __forceinline__ WideSmem wide_smem_layout(unsigned char* raw) {
  const Smem sm = aligned_smem(raw);
  WideSmem s;
  s.ring = sm.addr;
  s.act = reinterpret_cast<float4*>(sm.base + kStages * 64 * f32_pass(W));
  s.alpha = reinterpret_cast<float*>(s.act + (W / 8) * 128);
  s.staging = s.alpha + kPoints;
  s.bars = sm.addr + kStages * 64 * f32_pass(W) + (W / 8) * kStepBytes + 4 * kPoints + 2 * 4 * 256 * 4;
  return s;
}

// The tile's encoding k-steps (ps groups of 8, 4 a warpgroup) into `enc`
// (the CTA's stash past the layer's k-steps), between two barriers; into X
// too where given.
__device__ __forceinline__ void stage_wide_encoding(float4* enc, const float* __restrict__ encoded, int point, int n,
                                                    int pe, int ps, int wg, int t, int q, float* x_scr = nullptr,
                                                    int x_feats = 0, int row = 0) {
  consumer_sync();
  for (int e = 0; e < ps; ++e) {
    float v[16];
    load_encoding_f32<4>(v, encoded, point, n, pe, q, 8 * e + 4 * wg);
    stage_fragments<32>(enc + (8 * e + 4 * wg) * 128 + t, v);
    if (x_scr != nullptr) store_transposed<32>(x_scr, x_feats, 64 * e + 32 * wg, v, row, q);
  }
  consumer_sync();
}

// Pass c of forward layer i for the warpgroup's H = NP / 2 columns: sum =
// A_i @ W_i, the layer's slots of the pass in image order.
template <int W>
__device__ __forceinline__ void wide_forward_pass(float* sum, Ring& r, int i, int skip, int ps, const float4* act,
                                                  const float4* enc, int wg, int lane) {
  constexpr int NP = f32_pass(W), H = NP / 2, kStage = 64 * NP;
  zero<H / 2>(sum);
  if (i == 0) {
    product<H, kStage>(sum, r, enc, 8 * ps, wg * H * 32, NP, lane);
  } else {
    product<H, kStage>(sum, r, act, W / 8, wg * H * 32, NP, lane);
    if (i == skip) product<H, kStage>(sum, r, enc, 8 * ps, wg * H * 32, NP, lane);
  }
}

// The inverse of stage_fragments.
template <int N>
__device__ __forceinline__ void unstage_fragments(float* v, const float4* src) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float4 f = src[128 * j];
    v[4 * j] = f.x;
    v[4 * j + 2] = f.y;
    v[4 * j + 1] = f.z;
    v[4 * j + 3] = f.w;
  }
}

// After a layer's passes: once every product has read the staging, the
// thread's stashed fragments (its H columns of each pass) go into it.
template <int W>
__device__ __forceinline__ void unstash(const WideSmem& sm, const float4* stash, int wg, int t) {
  constexpr int NP = f32_pass(W), H = NP / 2;
  consumer_sync();
#pragma unroll
  for (int c = 0; c < W / NP; ++c)
#pragma unroll 4
    for (int j = 0; j < H / 8; ++j) {
      const int k = (NP * c + H * wg) / 8 + j;
      sm.act[k * 128 + t] = stash[k * 128 + t];
    }
  consumer_sync();
}

// A CTA's stash: the layer's W / 8 k-steps, then the encoding's 8 ps.
template <int W>
__device__ __forceinline__ float4* cta_stash(float4* stash, int ps) {
  return stash + (size_t)blockIdx.x * (W / 8 + 8 * ps) * 128;
}

template <int W>
__global__ void __launch_bounds__(kF32Threads, 1)
    backbone_f32_wide_fwd_kernel(const float* __restrict__ encoded, const float* __restrict__ image,
                                 const float* __restrict__ biases, const float* __restrict__ w_alpha,
                                 float* __restrict__ h_out, float* __restrict__ alpha_out, float4* stash, int n, int pe,
                                 int layers, int skip) {
  constexpr int NP = f32_pass(W), P = W / NP, H = NP / 2, kStage = 64 * NP;
  extern __shared__ unsigned char smem_raw[];
  const WideSmem sm = wide_smem_layout<W>(smem_raw);
  Ring ring;
  init_ring(ring, sm.ring, sm.bars, kStages, 8);
  const int ps = (pe + 63) / 64;
  const int tiles = (n + kPoints - 1) / kPoints;
  const int slots = rows_before_pe(layers, W, skip, 64 * ps) * P / 8;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int s = 0; s < slots; ++s) produce<kStage>(ring, image + (size_t)s * 16 * NP, 64 * NP);
  } else {
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t & 31, q = lane & 3, g = lane >> 2;
    const float b_alpha = __ldg(biases + layers * W);
    float4* mine = cta_stash<W>(stash, ps) + t;
    float4* enc = mine + (W / 8) * 128;
    float sum[H / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = tile * kPoints + 16 * (t >> 5) + g;
      stage_wide_encoding(enc - t, encoded, r0, n, pe, ps, wg, t, q);
      float s0 = 0.0f, s1 = 0.0f;
      for (int i = 0; i < layers; ++i) {
        for (int c = 0; c < P; ++c) {
          wide_forward_pass<W>(sum, ring, i, skip, ps, sm.act + t, enc, wg, lane);
          const int col0 = NP * c + H * wg;
          bias_relu<H>(sum, biases + i * W + col0, t);
          if (i + 1 < layers) {
            stage_fragments<H>(mine + (col0 / 8) * 128, sum);
            continue;
          }
          // h, and this pass's part of alpha = h . w_alpha.
#pragma unroll
          for (int j = 0; j < H / 8; ++j) {
            const int col = col0 + 8 * j + 2 * q;
            const float2 wa = __ldg(reinterpret_cast<const float2*>(w_alpha + col));
            s0 = fmaf(sum[4 * j + 1], wa.y, fmaf(sum[4 * j], wa.x, s0));
            s1 = fmaf(sum[4 * j + 3], wa.y, fmaf(sum[4 * j + 2], wa.x, s1));
            if (r0 < n) *reinterpret_cast<float2*>(h_out + (size_t)r0 * W + col) = make_float2(sum[4 * j], sum[4 * j + 1]);
            if (r0 + 8 < n)
              *reinterpret_cast<float2*>(h_out + (size_t)(r0 + 8) * W + col) = make_float2(sum[4 * j + 2], sum[4 * j + 3]);
          }
        }
        if (i + 1 < layers) unstash<W>(sm, mine - t, wg, t);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const int row = 16 * (t >> 5) + g;
      if (wg == 1 && q == 0) {
        sm.alpha[row] = s0;
        sm.alpha[row + 8] = s1;
      }
      consumer_sync();
      if (wg == 0 && q == 0) {
        if (r0 < n) alpha_out[r0] = (s0 + sm.alpha[row]) + b_alpha;
        if (r0 + 8 < n) alpha_out[r0 + 8] = (s1 + sm.alpha[row + 8]) + b_alpha;
      }
    }
  }
}

// The wide backward's tile kernel: the recompute keeps each pass's ReLU bits
// (masks (grid, L, W / 128, 256): NP / 128 words a pass) and X, and stashes
// the last layer's h for the alpha head; then back-propagates pass by pass:
// g_in's pass (the encoding's 64-row groups first, into d_encoded), masked
// by the layer below's bits, into G, its column sums and the stash.
// The wide tile kernel's parameters: the 256-wide kernel's, its stash and
// the encoding's blocks.
struct WideBwdTileParams : BwdTileParams {
  float4* stash;  // (grid, W / 8 + 8 ps, 128): a layer's outputs, each thread's own, then the encoding's fragments
  int ps;         // 64-column blocks of the encoding
};

template <int W>
__global__ void __launch_bounds__(kF32Threads, 1)
    backbone_f32_wide_bwd_tile_kernel(const __grid_constant__ WideBwdTileParams p) {
  constexpr int NP = f32_pass(W), P = W / NP, H = NP / 2, kStage = 64 * NP;
  constexpr int kPassWords = H / 64, kWords = P * kPassWords;
  extern __shared__ unsigned char smem_raw[];
  const WideSmem sm = wide_smem_layout<W>(smem_raw);
  Ring ring;
  init_ring(ring, sm.ring, sm.bars, kStages, 8);
  const int L = p.layers, skip = p.skip, ps = p.ps, pe_pad = 64 * ps;
  const int slots = rows_before_pe(L, W, skip, pe_pad) * P / 8;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int s = 0; s < slots; ++s) produce<kStage>(ring, p.fwd_image + (size_t)s * 16 * NP, 64 * NP);
        for (int i = L - 1; i >= 0; --i) {
          const float* src = p.bwd_image + 2 * (size_t)W * rows_before_pe(i, W, skip, pe_pad);
          if (i == 0 || i == skip)
            for (int k = 0; k < ps * W / 8; ++k, src += 16 * 64) produce<kStage>(ring, src, 64 * 64);
          if (i > 0)
            for (int k = 0; k < P * W / 8; ++k, src += 16 * NP) produce<kStage>(ring, src, 64 * NP);
        }
      }
    }
  } else {
    const int ct = threadIdx.x, wg = ct / 128, t = ct % 128, lane = t & 31, q = lane & 3, g = lane >> 2;
    float* staging = sm.staging + wg * 1024;
    const int tp_ld = L * W + W + 1;
    float* tp = p.tile_part + ((size_t)blockIdx.x * 2 + wg) * tp_ld;
    uint32_t* masks = p.masks + (size_t)blockIdx.x * L * kWords * kConsumers + ct;
    float4* mine = cta_stash<W>(p.stash, ps) + t;
    float4* enc = mine + (W / 8) * 128;
    float sum[H / 2];

    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int row = tile * kPoints + 16 * (t >> 5) + g;  // of the chunk
      const int r0 = p.first_tile * kPoints + row;         // the point
      stage_wide_encoding(enc - t, p.encoded, r0, p.n, p.pe, ps, wg, t, q, p.x_scr, p.x_feats, row);
      // Recompute; X <- every layer's input, masks <- each pass's ReLU.
      for (int i = 0; i < L; ++i) {
        for (int c = 0; c < P; ++c) {
          wide_forward_pass<W>(sum, ring, i, skip, ps, sm.act + t, enc, wg, lane);
          const int col0 = NP * c + H * wg;
          bias_relu<H>(sum, p.biases + i * W + col0, t);
#pragma unroll
          for (int w = 0; w < kPassWords; ++w) {
            uint32_t m = 0;
#pragma unroll
            for (int b = 0; b < 32; ++b) m |= (sum[32 * w + b] > 0.0f ? 1u : 0u) << b;
            masks[((size_t)i * kWords + kPassWords * c + w) * kConsumers] = m;
          }
          if (i + 1 < L) store_transposed<H>(p.x_scr, p.x_feats, pe_pad + i * W + col0, sum, row, q);
          stage_fragments<H>(mine + (col0 / 8) * 128, sum);
        }
        if (i + 1 < L) unstash<W>(sm, mine - t, wg, t);
      }
      consumer_sync();  // the last layer's products are done with the encoding's fragments

      // The alpha head: dW_alpha += h^T g_alpha (db_alpha: backbone_f32_alpha_bias_kernel).
      const float ga0 = r0 < p.n ? p.g_alpha[r0] : 0.0f;
      const float ga1 = r0 + 8 < p.n ? p.g_alpha[r0 + 8] : 0.0f;
      for (int c = 0; c < P; ++c) {
        const int col0 = NP * c + H * wg;
        unstage_fragments<H>(sum, mine + (col0 / 8) * 128);
#pragma unroll
        for (int v = 0; v < H / 2; ++v) sum[v] *= (v & 2) ? ga1 : ga0;
        column_sums<H>(sum, staging, tp + L * W + col0, wg, t, false);
      }
      // A pass of g for layer `l`, in sum: masked, into G, its column sums, stashed.
      auto g_pass = [&](int l, int c) {
        const int col0 = NP * c + H * wg;
#pragma unroll
        for (int w = 0; w < kPassWords; ++w) {
          const uint32_t m = masks[((size_t)l * kWords + kPassWords * c + w) * kConsumers];
#pragma unroll
          for (int k = 0; k < 32; ++k) sum[32 * w + k] = ((m >> k) & 1u) ? sum[32 * w + k] : 0.0f;
        }
        store_transposed<H>(p.g_scr, p.g_feats, l * W + col0, sum, row, q);
        column_sums<H>(sum, staging, tp + l * W + col0, wg, t, false);
        stage_fragments<H>(mine + (col0 / 8) * 128, sum);
      };
      // g = g_h + g_alpha w_alpha^T.
      for (int c = 0; c < P; ++c) {
        const int col0 = NP * c + H * wg;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const int col = col0 + 8 * j + 2 * q;
          const float2 wa = __ldg(reinterpret_cast<const float2*>(p.w_alpha + col));
          const float2 h0 = r0 < p.n ? *reinterpret_cast<const float2*>(p.g_h + (size_t)r0 * W + col)
                                     : make_float2(0.0f, 0.0f);
          const float2 h1 = r0 + 8 < p.n ? *reinterpret_cast<const float2*>(p.g_h + (size_t)(r0 + 8) * W + col)
                                         : make_float2(0.0f, 0.0f);
          sum[4 * j] = fmaf(ga0, wa.x, h0.x);
          sum[4 * j + 1] = fmaf(ga0, wa.y, h0.y);
          sum[4 * j + 2] = fmaf(ga1, wa.x, h1.x);
          sum[4 * j + 3] = fmaf(ga1, wa.y, h1.y);
        }
        g_pass(L - 1, c);
      }
      unstash<W>(sm, mine - t, wg, t);
      for (int i = L - 1; i >= 0; --i) {
        // g_in = g @ W_i^T: the encoding's rows first (32 of each 64-row
        // group a warpgroup, a term of d_encoded, layer 0's added to the skip
        // layer's), then the activation rows pass by pass, the next g.
        if (i == 0 || i == skip) {
          const bool add = i == 0 && skip < L;
          for (int e = 0; e < ps; ++e) {
            zero<16>(sum);
            product<32, kStage>(sum, ring, sm.act + t, W / 8, wg * 32 * 32, 64, lane);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int point = r0 + 8 * (k >> 1), col = 64 * e + wg * 32 + 8 * j + 2 * q + (k & 1);
                float* d = p.d_encoded + (size_t)point * p.pe + col;
                if (point < p.n && col < p.pe) *d = add ? *d + sum[4 * j + k] : sum[4 * j + k];
              }
          }
        }
        if (i > 0) {
          for (int c = 0; c < P; ++c) {
            zero<H / 2>(sum);
            product<H, kStage>(sum, ring, sm.act + t, W / 8, wg * H * 32, NP, lane);
            g_pass(i - 1, c);
          }
          unstash<W>(sm, mine - t, wg, t);
        }
      }
    }
  }
}

// db_alpha of the wide backward: the sum of g_alpha over every point in f64
// in a fixed order (one block: thread k sums points k, k + 256, ..., then
// the 256 partials in a tree of fixed shape). The wide tile kernel sums no
// per-tile partials for it: each rounded to f32 in tile_part, they lose the
// low bits a sum that cancels to far less than its terms keeps.
__global__ void backbone_f32_alpha_bias_kernel(const float* __restrict__ g_alpha, int n, float* __restrict__ out) {
  __shared__ double part[256];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += 256) s += g_alpha[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)part[0];
}

// ---- the weight images ------------------------------------------------------------

struct PackParams {
  const float* w[kMaxLayers];      // layer first + i's weight (in, W): element (r, c) at r * ws[i][0] + c * ws[i][1]
  long long ws[kMaxLayers][2];
  const float* b[kMaxLayers];      // b_{first + i}: element c at c * bs[i]
  long long bs[kMaxLayers];
  const float* w_alpha;            // (W, 1): element c at c * was
  long long was;
  const float* b_alpha;
  float* fwd;
  float* bwd;
  float* biases;                   // b_0 .. b_{L-1}, b_alpha
  float* w_alpha_out;              // W
  int width, skip, pe;
  int np, pe_pad;                  // pass width (f32_pass); the encoding's rows, padded to 64 ps
  int first, count;                // this launch's layers [first, first + count)
  int row0, rows;                  // their padded rows [row0, row0 + rows)
  int last;                        // whether they end the network: b_alpha and w_alpha too
};

// Float offset of (n, k) in a slot part of wgmma's layout without swizzle.
__host__ __device__ constexpr int frag_offset(int n, int k) {
  return (n >> 3) * 64 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// The logical k of physical column m of an 8-column step (pi's inverse).
__host__ __device__ constexpr int logical_k(int m) { return (m >> 1) + 4 * (m & 1); }

// One thread a padded weight element of the launch's layers (layer i,
// padded input row rr, output column c): its big and small halves into both
// images; then one a bias of those layers, and on the last launch one for
// b_alpha and one a w_alpha element. A network deeper than kMaxLayers is
// packed by consecutive launches of kMaxLayers layers (their pointers are
// the kernel parameter).
__global__ void backbone_f32_pack_kernel(const __grid_constant__ PackParams p) {
  const int W = p.width, np = p.np, pe_pad = p.pe_pad;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long weights = (long long)p.rows * W;
  if (idx < weights) {
    const int r = p.row0 + (int)(idx / W), c = (int)(idx % W);
    int i = p.first, before = p.row0;
    while (r - before >= in_pad_pe(i, W, p.skip, pe_pad)) before += in_pad_pe(i++, W, p.skip, pe_pad);
    const int rr = r - before;
    bool real = rr < W;                                   // an activation row
    if (i == 0) real = rr < p.pe;                          // the encoding's, padded to pe_pad
    else if (i == p.skip && rr >= W) real = rr - W < p.pe;
    const int li = i - p.first;
    const float w = real ? p.w[li][rr * p.ws[li][0] + c * p.ws[li][1]] : 0.0f;
    const uint32_t big = tf32_rna(w), small = tf32_rna(w - __uint_as_float(big));
    const size_t base = 2 * (size_t)W * before;
    const int k_steps = in_pad_pe(i, W, p.skip, pe_pad) / 8;
    const size_t f = base + ((size_t)(c / np) * k_steps + (rr >> 3)) * 16 * np + frag_offset(c % np, logical_k(rr & 7));
    p.fwd[f] = __uint_as_float(big);
    p.fwd[f + 8 * np] = __uint_as_float(small);
    // bwd: groups of N rows, each W / 8 slots: the encoding's 64-row groups
    // first (layer 0 and the skip layer), then the activation rows in
    // groups of np.
    int rows = np, nn = rr % np;
    size_t b = base;
    if (i == 0 || (i == p.skip && rr >= W)) {
      const int e = i == 0 ? rr : rr - W;
      rows = 64;
      nn = e % 64;
      b += (size_t)(e / 64) * (W / 8) * 16 * 64;
    } else {
      if (i == p.skip) b += (size_t)(pe_pad / 64) * (W / 8) * 16 * 64;
      b += (size_t)(rr / np) * (W / 8) * 16 * np;
    }
    b += (size_t)(c >> 3) * 16 * rows + frag_offset(nn, logical_k(c & 7));
    p.bwd[b] = __uint_as_float(big);
    p.bwd[b + 8 * rows] = __uint_as_float(small);
  } else if (idx < weights + (long long)p.count * W + p.last) {
    const int j = (int)(idx - weights), li = j / W;
    if (li < p.count) p.biases[(p.first + li) * W + j % W] = p.b[li][(j % W) * p.bs[li]];
    else p.biases[(p.first + p.count) * W] = p.b_alpha[0];
  } else if (p.last && idx < weights + (long long)p.count * W + 1 + W) {
    const int c = (int)(idx - weights - (long long)p.count * W - 1);
    p.w_alpha_out[c] = p.w_alpha[c * p.was];
  }
}

// ---- host side ----------------------------------------------------------------------

template <int W>
__host__ __device__ constexpr int dw_cols() {
  return W < 128 ? W : 128;
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
  e = cudaFuncSetAttribute(backbone_f32_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)tile_smem<W>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(backbone_f32_bwd_tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile_smem<W>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(backbone_f32_dw_kernel<dw_cols<W>()>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem<dw_cols<W>()>());
  done[device] = e == cudaSuccess;
  return e;
}

template <int W>
int fwd_launch(const float* encoded, const float* image, const float* biases, const float* w_alpha, float* h,
               float* alpha, int n, int pe, int layers, int skip, int grid, cudaStream_t stream) {
  cudaError_t err = prepare<W>();
  if (err != cudaSuccess) return (int)err;
  backbone_f32_fwd_kernel<W><<<grid, kF32Threads, tile_smem<W>(), stream>>>(encoded, image, biases, w_alpha, h, alpha,
                                                                         n, pe, layers, skip);
  return (int)cudaGetLastError();
}

// Accumulates into ms[which] the milliseconds between two events (a
// measurement path; the call then waits for each launch).
struct Timer {
  float* ms;
  cudaEvent_t start, stop;
  cudaStream_t stream;
  void begin() {
    if (ms) cudaEventRecord(start, stream);
  }
  void end(int which) {
    if (!ms) return;
    cudaEventRecord(stop, stream);
    cudaEventSynchronize(stop);
    float t = 0.0f;
    cudaEventElapsedTime(&t, start, stop);
    ms[which] += t;
  }
};

template <int W>
cudaError_t prepare_wide() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(backbone_f32_wide_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wide_smem<W>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(backbone_f32_wide_bwd_tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wide_smem<W>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(backbone_f32_dw_kernel<dw_cols<W>()>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem<dw_cols<W>()>());
  done[device] = e == cudaSuccess;
  return e;
}

// The backward's launches; `kWide` the wide tile kernel (WideBwdTileParams).
template <int W, bool kWide = false, typename Params>
int bwd_launch(Params tp, const int* table, int row_blocks, float* partial, float* grads_out, int grid,
               int chunk_tiles, int splits, cudaStream_t stream, float* ms) {
  constexpr int NB = dw_cols<W>();
  cudaError_t err;
  int pe_pad = kPe;
  if constexpr (kWide) {
    err = prepare_wide<W>();
    pe_pad = 64 * tp.ps;
  } else {
    err = prepare<W>();
  }
  if (err != cudaSuccess) return (int)err;
  const int L = tp.layers;
  const int rows_pad = rows_before_pe(L, W, tp.skip, pe_pad);
  const int tp_ld = L * W + W + 1;
  const size_t dw_elems = (size_t)rows_pad * W;
  err = cudaMemsetAsync(tp.tile_part, 0, sizeof(float) * (size_t)2 * grid * tp_ld, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)splits * dw_elems, stream);
  if (err != cudaSuccess) return (int)err;
  Timer timer{ms, nullptr, nullptr, stream};
  if (ms) {
    ms[0] = ms[1] = ms[2] = 0.0f;
    cudaEventCreate(&timer.start);
    cudaEventCreate(&timer.stop);
  }
  const int tiles = (tp.n + kPoints - 1) / kPoints;
  for (int first = 0; first < tiles && err == cudaSuccess; first += chunk_tiles) {
    tp.first_tile = first;
    tp.tiles = min(chunk_tiles, tiles - first);
    timer.begin();
    if constexpr (kWide)
      backbone_f32_wide_bwd_tile_kernel<W><<<grid, kF32Threads, wide_smem<W>(), stream>>>(tp);
    else
      backbone_f32_bwd_tile_kernel<W><<<grid, kF32Threads, tile_smem<W>(), stream>>>(tp);
    err = cudaGetLastError();
    timer.end(0);
    if (err != cudaSuccess) break;
    const int blocks = tp.tiles * (kPoints / 32);
    DwParams dp{tp.x_scr, tp.g_scr, table, partial, blocks, (blocks + splits - 1) / splits, tp.x_feats, tp.g_feats,
                rows_pad, W};
    timer.begin();
    backbone_f32_dw_kernel<NB><<<dim3(row_blocks * (W / NB), splits), kF32Threads, dw_smem<NB>(), stream>>>(dp);
    err = cudaGetLastError();
    timer.end(1);
  }
  if (err == cudaSuccess) {
    const size_t total = dw_elems + tp_ld;
    timer.begin();
    backbone_f32_grad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, splits, dw_elems, tp.tile_part, 2 * grid, tp_ld, grads_out);
    err = cudaGetLastError();
    if constexpr (kWide) {
      if (err == cudaSuccess) {
        backbone_f32_alpha_bias_kernel<<<1, 256, 0, stream>>>(tp.g_alpha, tp.n, grads_out + dw_elems + tp_ld - 1);
        err = cudaGetLastError();
      }
    }
    timer.end(2);
  }
  if (ms) {
    cudaEventDestroy(timer.start);
    cudaEventDestroy(timer.stop);
  }
  return (int)err;
}

}  // namespace

// Each launcher runs on `stream` and returns the CUDA error code (0 on
// success). Shapes and limits (width in {64, 128, 256}, pe <= 64, layers <=
// 8, skip == layers for none), the grid (min(tiles, SMs), tiles = ceil(N /
// 128)), chunk and split counts, the row block table and every buffer come
// from the Python wrapper (ops/fused_nerf.py).

// The images of one weight set: w, b (layers pointers each), w_strides (2
// per layer) and b_strides (1 per layer) in elements; fwd and bwd 2 x
// rows_pad x W floats each, biases L W + 1, w_alpha_out W.
extern "C" int backbone_f32_pack_launch(const void* const* w, const long long* w_strides, const void* const* b,
                                        const long long* b_strides, const void* w_alpha, long long w_alpha_stride,
                                        const void* b_alpha, void* fwd, void* bwd, void* biases, void* w_alpha_out,
                                        int width, int layers, int skip, int pe, int pe_pad, void* stream) {
  if (layers < 1 || (width != 64 && width != 128 && width != 256 && width != 512 && width != 640) ||
      pe > pe_pad || pe_pad > 256)
    return (int)cudaErrorInvalidValue;
  PackParams p{};
  p.w_alpha = (const float*)w_alpha;
  p.was = w_alpha_stride;
  p.b_alpha = (const float*)b_alpha;
  p.fwd = (float*)fwd;
  p.bwd = (float*)bwd;
  p.biases = (float*)biases;
  p.w_alpha_out = (float*)w_alpha_out;
  p.width = width;
  p.skip = skip;
  p.pe = pe;
  p.np = f32_pass(width);
  p.pe_pad = pe_pad;
  for (int first = 0; first < layers; first += kMaxLayers) {
    p.first = first;
    p.count = min(kMaxLayers, layers - first);
    p.last = first + p.count == layers;
    for (int i = 0; i < p.count; ++i) {
      p.w[i] = (const float*)w[first + i];
      p.ws[i][0] = w_strides[2 * (first + i)];
      p.ws[i][1] = w_strides[2 * (first + i) + 1];
      p.b[i] = (const float*)b[first + i];
      p.bs[i] = b_strides[first + i];
    }
    p.row0 = rows_before_pe(first, width, skip, pe_pad);
    p.rows = rows_before_pe(first + p.count, width, skip, pe_pad) - p.row0;
    const long long total = (long long)p.rows * width + (long long)p.count * width + (p.last ? 1 + width : 0);
    backbone_f32_pack_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int backbone_f32_fwd_launch(const void* encoded, const void* image, const void* biases,
                                       const void* w_alpha, void* h, void* alpha, int n, int pe, int width,
                                       int layers, int skip, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FWD(W)                                                                                                      \
  fwd_launch<W>((const float*)encoded, (const float*)image, (const float*)biases, (const float*)w_alpha, (float*)h, \
                (float*)alpha, n, pe, layers, skip, grid, s)
  switch (width) {
    case 64: return FWD(64);
    case 128: return FWD(128);
    case 256: return FWD(256);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// Scratch (ops/fused_nerf.py::backbone_f32_scratch_shapes): x_scr, g_scr
// (chunk points / 32, features, 32) f32; tile_part f32 (2 grid, L W + W +
// 1); partial f32 (splits, rows_pad, W); masks u32 (grid, L, W / 64, 256).
// grads_out f32: (rows_pad, W) weight gradients in the padded row order,
// then db_0 .. db_{L-1}, dW_alpha (W), db_alpha (1). ms: null, or 3 floats
// that receive the tile kernels', the dW kernels' and the reduction's
// milliseconds summed over chunks (the call then waits for each launch).
extern "C" int backbone_f32_bwd_launch(const void* encoded, const void* g_h, const void* g_alpha,
                                       const void* fwd_image, const void* bwd_image, const void* biases,
                                       const void* w_alpha, void* d_encoded, void* x_scr, void* g_scr,
                                       void* tile_part, void* partial, void* masks, const void* table,
                                       void* grads_out, int row_blocks, int n, int pe, int width, int layers,
                                       int skip, int grid, int chunk_tiles, int splits, void* stream, float* ms) {
  const int x_feats = kPe + (layers - 1) * width, g_feats = layers * width;
  BwdTileParams tp{(const float*)encoded, (const float*)g_h, (const float*)g_alpha, (const float*)fwd_image,
                   (const float*)bwd_image, (const float*)biases, (const float*)w_alpha, (float*)d_encoded,
                   (float*)x_scr, (float*)g_scr, (float*)tile_part, (uint32_t*)masks, n, pe, layers, skip, 0, 0,
                   x_feats, g_feats};
  cudaStream_t s = (cudaStream_t)stream;
#define BWD(W) \
  bwd_launch<W>(tp, (const int*)table, row_blocks, (float*)partial, (float*)grads_out, grid, chunk_tiles, splits, s, ms)
  switch (width) {
    case 64: return BWD(64);
    case 128: return BWD(128);
    case 256: return BWD(256);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}

// The wide kernels (width 256, 512 or 640, pe <= 256, any depth; grid
// min(tiles, SMs), tiles = ceil(N / 64)): as backbone_f32_fwd_launch and
// backbone_f32_bwd_launch with the images of backbone_f32_pack_launch at
// pe_pad = 64 ps, ps = ceil(pe / 64), and stash f32 (grid, W / 8 + 8 ps,
// 128, 4); the backward's masks u32 (grid, L, W / 128, 256), its scratch
// with pe_pad encoding features in X.
extern "C" int backbone_f32_wide_fwd_launch(const void* encoded, const void* image, const void* biases,
                                            const void* w_alpha, void* h, void* alpha, void* stash, int n, int pe,
                                            int width, int layers, int skip, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (pe > 256) return (int)cudaErrorInvalidValue;
#define FWD(W)                                                                                                   \
  do {                                                                                                           \
    cudaError_t err = prepare_wide<W>();                                                                         \
    if (err != cudaSuccess) return (int)err;                                                                     \
    backbone_f32_wide_fwd_kernel<W><<<grid, kF32Threads, wide_smem<W>(), s>>>(                                   \
        (const float*)encoded, (const float*)image, (const float*)biases, (const float*)w_alpha, (float*)h,      \
        (float*)alpha, (float4*)stash, n, pe, layers, skip);                                                     \
    return (int)cudaGetLastError();                                                                              \
  } while (0)
  switch (width) {
    case 256: FWD(256);
    case 512: FWD(512);
    case 640: FWD(640);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int backbone_f32_wide_bwd_launch(const void* encoded, const void* g_h, const void* g_alpha,
                                            const void* fwd_image, const void* bwd_image, const void* biases,
                                            const void* w_alpha, void* d_encoded, void* x_scr, void* g_scr,
                                            void* tile_part, void* partial, void* masks, void* stash,
                                            const void* table, void* grads_out, int row_blocks, int n, int pe,
                                            int width, int layers, int skip, int grid, int chunk_tiles, int splits,
                                            void* stream, float* ms) {
  if (pe > 256) return (int)cudaErrorInvalidValue;
  const int ps = (pe + 63) / 64;
  const int x_feats = 64 * ps + (layers - 1) * width, g_feats = layers * width;
  WideBwdTileParams tp{{(const float*)encoded, (const float*)g_h, (const float*)g_alpha, (const float*)fwd_image,
                        (const float*)bwd_image, (const float*)biases, (const float*)w_alpha, (float*)d_encoded,
                        (float*)x_scr, (float*)g_scr, (float*)tile_part, (uint32_t*)masks, n, pe, layers, skip, 0, 0,
                        x_feats, g_feats},
                       (float4*)stash, ps};
  cudaStream_t s = (cudaStream_t)stream;
#define BWD(W)                                                                                                  \
  bwd_launch<W, true>(tp, (const int*)table, row_blocks, (float*)partial, (float*)grads_out, grid, chunk_tiles, \
                      splits, s, ms)
  switch (width) {
    case 256: return BWD(256);
    case 512: return BWD(512);
    case 640: return BWD(640);
  }
#undef BWD
  return (int)cudaErrorInvalidValue;
}
