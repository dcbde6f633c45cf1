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
//    tile kernel's rows, each in index order.
// The launcher walks the points in chunks of `chunk_tiles` tiles (1,024,
// ops/fused_nerf.py::_F32_CHUNK_TILES) so that the X and G scratch stay
// bounded, ~1 GB at the tennis widths (backbone_f32_scratch_shapes); the
// slabs and the column-sum rows accumulate across chunks in place.
//
// Times on the card and what they are held against: PERF.md (chip_smoke.py
// phase 14a).

#include "nerf_wgmma.cuh"

namespace {

constexpr int kMaxLayers = 8;
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

// Producer: `bytes` (at most kStageBytes) from `src` into the next slot once
// every consumer warp has released it.
__device__ __forceinline__ void produce(Ring& r, const float* src, uint32_t bytes) {
  mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1);
  mbar_expect_tx(r.full + 8 * r.stage, bytes);
  bulk_load(r.slots + r.stage * kStageBytes, src, bytes, r.full + 8 * r.stage);
  ring_advance<kStages>(r);
}

// Consumer: waits for the next slot and issues its three products for the
// warpgroup's H columns (rows n_off / 32 .. of the slot's n_all) into acc,
// fresh or added to.
template <int H>
__device__ __forceinline__ void issue(float* acc, Ring& r, const uint32_t* big, const uint32_t* small,
                                      uint32_t n_off, int n_all, int scale_d) {
  mbar_wait(r.full + 8 * r.stage, r.phase);
  wgmma_fence();
  const uint32_t slot = r.slots + r.stage * kStageBytes + n_off;
  mma3<H>(acc, big, small, plain_desc(slot), plain_desc(slot + n_all * 32), scale_d);
  ring_advance<kStages>(r);
}

// sum += A B over `steps` slots for the warpgroup's H columns, A's k-step s
// the thread's fragment a[128 s] in the staging. Two slots' products go
// into a fresh accumulator and then into `sum`: the tensor cores truncate
// every sum they accumulate, which over a layer's 120 products drifts
// enough to flip ReLUs, while `sum` rounds to nearest.
template <int H>
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
    issue<H>(acc, r, big0, small0, n_off, n_all, 0);
    issue<H>(acc, r, big1, small1, n_off, n_all, 1);
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

// ---- the weight images ------------------------------------------------------------

struct PackParams {
  const float* w[kMaxLayers];      // layer i's weight (in_i, W): element (r, c) at r * ws[i][0] + c * ws[i][1]
  long long ws[kMaxLayers][2];
  const float* b[kMaxLayers];      // b_i: element c at c * bs[i]
  long long bs[kMaxLayers];
  const float* w_alpha;            // (W, 1): element c at c * was
  long long was;
  const float* b_alpha;
  float* fwd;
  float* bwd;
  float* biases;                   // b_0 .. b_{L-1}, b_alpha
  float* w_alpha_out;              // W
  int width, layers, skip, pe, rows_pad;
};

// Float offset of (n, k) in a slot part of wgmma's layout without swizzle.
__host__ __device__ constexpr int frag_offset(int n, int k) {
  return (n >> 3) * 64 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// The logical k of physical column m of an 8-column step (pi's inverse).
__host__ __device__ constexpr int logical_k(int m) { return (m >> 1) + 4 * (m & 1); }

// One thread a padded weight element (layer i, padded input row rr, output
// column c): its big and small halves into both images; then one a bias and
// one a w_alpha element.
__global__ void backbone_f32_pack_kernel(const __grid_constant__ PackParams p) {
  const int W = p.width;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long weights = (long long)p.rows_pad * W;
  if (idx < weights) {
    const int r = (int)(idx / W), c = (int)(idx % W);
    int i = 0, before = 0;
    while (r - before >= in_pad(i, W, p.skip)) before += in_pad(i++, W, p.skip);
    const int rr = r - before;
    bool real = rr < W;                                   // an activation row
    if (i == 0) real = rr < p.pe;                          // the encoding's, padded to 64
    else if (i == p.skip && rr >= W) real = rr - W < p.pe;
    const float w = real ? p.w[i][rr * p.ws[i][0] + c * p.ws[i][1]] : 0.0f;
    const uint32_t big = tf32_rna(w), small = tf32_rna(w - __uint_as_float(big));
    const size_t base = 2 * (size_t)W * before;
    const size_t f = base + (size_t)(rr >> 3) * 16 * W + frag_offset(c, logical_k(rr & 7));
    p.fwd[f] = __uint_as_float(big);
    p.fwd[f + 8 * W] = __uint_as_float(small);
    int rows = W, nn = rr;
    size_t b = base;
    if (i == 0) {
      rows = kPe;
    } else if (i == p.skip) {
      if (rr >= W) {
        rows = kPe;
        nn = rr - W;
      } else {
        b += (size_t)(W / 8) * 16 * kPe;
      }
    }
    b += (size_t)(c >> 3) * 16 * rows + frag_offset(nn, logical_k(c & 7));
    p.bwd[b] = __uint_as_float(big);
    p.bwd[b + 8 * rows] = __uint_as_float(small);
  } else if (idx < weights + (long long)p.layers * W + 1) {
    const int j = (int)(idx - weights), i = j / W;
    p.biases[j] = i < p.layers ? p.b[i][(j % W) * p.bs[i]] : p.b_alpha[0];
  } else if (idx < weights + (long long)p.layers * W + 1 + W) {
    const int c = (int)(idx - weights - (long long)p.layers * W - 1);
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
int bwd_launch(BwdTileParams tp, const int* table, int row_blocks, float* partial, float* grads_out, int grid,
               int chunk_tiles, int splits, cudaStream_t stream, float* ms) {
  constexpr int NB = dw_cols<W>();
  cudaError_t err = prepare<W>();
  if (err != cudaSuccess) return (int)err;
  const int L = tp.layers;
  const int rows_pad = rows_before(L, W, tp.skip);
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
                                        int width, int layers, int skip, int pe, void* stream) {
  if (layers < 1 || layers > kMaxLayers || (width != 64 && width != 128 && width != 256) || pe > kPe)
    return (int)cudaErrorInvalidValue;
  PackParams p{};
  for (int i = 0; i < layers; ++i) {
    p.w[i] = (const float*)w[i];
    p.ws[i][0] = w_strides[2 * i];
    p.ws[i][1] = w_strides[2 * i + 1];
    p.b[i] = (const float*)b[i];
    p.bs[i] = b_strides[i];
  }
  p.w_alpha = (const float*)w_alpha;
  p.was = w_alpha_stride;
  p.b_alpha = (const float*)b_alpha;
  p.fwd = (float*)fwd;
  p.bwd = (float*)bwd;
  p.biases = (float*)biases;
  p.w_alpha_out = (float*)w_alpha_out;
  p.width = width;
  p.layers = layers;
  p.skip = skip;
  p.pe = pe;
  p.rows_pad = rows_before(layers, width, skip);
  const long long total = (long long)p.rows_pad * width + (long long)layers * width + 1 + width;
  backbone_f32_pack_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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
