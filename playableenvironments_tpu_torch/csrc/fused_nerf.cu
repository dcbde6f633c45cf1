// Fused eval AdaIN-NeRF MLP for Hopper (sm_90a): persistent wgmma kernel on
// 2-CTA clusters (bf16 operands, f32 accumulation), one launch for a group
// of objects.
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
// one point costs ~614k MAC against ~0.9 KB of input and output, so the
// kernel is bound by tensor-core operations: a tennis frame (155,520 points
// in four objects) is 1.9e11 FLOP, 0.19 ms at the card's dense bf16 peak.
// What the design keeps off that critical path is the weight image (1.23 MB
// per object at W 256), which every 128-point tile streams from L2: 1.5 GB a
// frame if each tile read it alone.
//
// Design. The backbone is B2's (fused_backbone.cu, through nerf_wgmma.cuh):
// one persistent CTA per SM, 128-point tiles, one producer thread (its
// warpgroup's registers handed to the consumers by setmaxnreg) streaming
// 64-row weight slots through a 4-stage mbarrier ring by bulk copies, two
// consumer warpgroups of 64 rows each running m64nNk16 wgmma with A = the
// tile's bf16 activations in shared memory (K-major, the encoding columns
// beside them for layer 0 and the skip layer) and B = the slot (MN-major).
// Epilogues run on the accumulators in registers and overwrite the
// warpgroup's own rows of the activation tile in place. The alpha head is a
// quad-shuffle dot product in the last backbone epilogue. Then the feature
// head on the same tile: f0 in two passes of m64n(W/2), each over W/64
// slots of one column half of W_f0 (the epilogue multiplies by
// scale0[ray], adds bias0[ray], applies ReLU; no epilogue then holds a
// W-column accumulator beside its modulation loads, which spilled), the
// first pass's output into the encoding tile and a spare 64-column block
// (the second pass still reads h), the second's over h's upper half; f1
// (m64n(W/2) over W_f1's slots, A = those four blocks, the same with
// scale1/bias1, into h's lower half); out (m64nNO over W_out's W/128
// slots, NO = the outputs rounded up to 64; + b_out, stored in f32 from
// registers, masked to the object's points). Modulation is read in the
// epilogues through the read-only path: a 128-point tile touches
// 128 / samples rays.
//
// Clusters. Two CTAs of a cluster take two tiles of the same object in
// lockstep and consume the same slot sequence: each CTA's producer copies
// half of every slot into both CTAs' rings with one multicast bulk copy, so
// the pair reads the weight image from L2 once for two tiles; a slot's
// `empty` barrier counts the consumer warps of both CTAs (the partner's
// arrive remotely). A pair whose second tile is past the object's end runs
// the slot sequence with all rows masked, so the rings stay in step, and
// the CTAs meet at a cluster barrier before they exit, so that neither
// leaves while the other can still write into its shared memory. On the
// H100 the halved weight stream did not make the kernel faster: L2 feeds
// the unshared stream too, and clusters of 1 run a few percent faster
// (PERF.md, scripts/ablate_adain_nerf.py).
//
// Grouping. One launch walks a table of pairs (units of kCtas tiles) over a
// group of objects that share one MLP configuration (each its own weights,
// encodings, modulation and samples per ray): pairs never straddle objects,
// and cluster c takes pairs c, c + clusters, ... The grid is as many
// clusters as the card places at once. The group, with the host's per-object
// pair prefix table, is one __grid_constant__ kernel parameter.
//
// Weight image (built by ops/fused_nerf.py::adain_image), bf16: B2's
// backbone image (backbone_buffers: every layer's 64-row slots, each W/64
// swizzled 64 x 64 blocks in wgmma's 128-byte swizzle, then w_alpha), then
// the head slots in the same swizzle: W_f0's columns [0, W/2), then its
// columns [W/2, W), each W/64 slots of 64 rows x W/2 columns; W_f1, W/64
// slots of 64 rows x W/2 columns; W_out, W/128 slots of 64 rows x NO
// columns (zero-padded from the outputs to NO). Biases, f32: b_0 ..
// b_{L-1}, b_alpha, b_out.
//
// Times on the card and what sets the kernel's pace: PERF.md (chip_smoke.py
// phase 2, scripts/ablate_adain_nerf.py).

#include "nerf_wgmma.cuh"

// CTAs per cluster: 2, or 1 in scripts/ablate_adain_nerf.py's builds, which
// time the kernel without the multicast (each CTA then streams every slot
// for its own tile).
#ifndef ADAIN_CLUSTER
#define ADAIN_CLUSTER 2
#endif

namespace {

constexpr int kCtas = ADAIN_CLUSTER;
static_assert(kCtas == 1 || kCtas == 2, "clusters of 1 or 2 CTAs");
constexpr int kStages = 4;
constexpr int kMaxObjects = 16;  // objects of one launch
// Shared memory: the ring, the activation tile, the encoding tile, one more
// 64-column block of 128 rows (f0's first pass keeps its output there and
// in the encoding tile) and the barriers.
constexpr size_t kSmem = 1024 + (size_t)kStages * kSlotBytes + kActBytes + 2 * kEncBytes + 256;

struct AdaObject {
  const bf16* encoded;          // (n_points, pe)
  const float* mod[4];          // scale0, bias0 (rays, W); scale1, bias1 (rays, W / 2)
  int ld[4];                    // their row strides, in floats
  const unsigned char* image;   // the weight image
  const float* biases;          // b_0 .. b_{L-1}, b_alpha, b_out
  float* features;              // (n_points, out)
  float* alpha;                 // (n_points,)
  int n_points, samples;
};

struct AdaGroup {
  int objects, pairs, pe, layers, skip, out;
  int pair_start[kMaxObjects + 1];  // object o's pairs are [pair_start[o], pair_start[o + 1])
  AdaObject obj[kMaxObjects];
};

__device__ __forceinline__ int object_of(const AdaGroup& g, int pair) {
  int o = 0;
  while (o + 1 < g.objects && pair >= g.pair_start[o + 1]) ++o;
  return o;
}

// One head layer for the warpgroup's 64 rows: acc (N columns) = A @ W over
// kSlots slots, A's K-major 64-column block j of 128 rows at block(j)
// (shared-memory address), each slot MN-major.
template <int N, int kSlots, typename Block>
__device__ __forceinline__ void head_layer(float* acc, Ring& r, Block block, int wg, int lane) {
  int prev = -1;
#pragma unroll 1
  for (int j = 0; j < kSlots; ++j) {
    const uint32_t a = block(j) + wg * 64 * 128;
    consume_slot<kStages, kCtas>(r, prev, lane, [&](uint32_t slot) {
      const uint64_t da = sw128_base(a, 16, 1024), db = sw128_base(slot, 8192, 1024);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma<N, 0, 1>(acc, da + 2 * k, db + 128 * k, (j > 0 || k > 0) ? 1 : 0);
    });
  }
  release_last<kCtas>(r, prev, lane);
  fence_regs<N / 2>(acc);
}

// acc = relu(acc * scale[ray] + bias[ray]) for the thread's two rows (rays
// ray0 and ray1) and N columns; scale and bias point at the first of those
// columns, their rows ld_s and ld_b floats apart.
template <int N>
__device__ __forceinline__ void modulate_relu(float* acc, const float* __restrict__ scale, int ld_s,
                                              const float* __restrict__ bias, int ld_b, int ray0, int ray1,
                                              int t) {
  const int q = t & 3;
  const float* s0 = scale + (size_t)ray0 * ld_s + 2 * q;
  const float* b0 = bias + (size_t)ray0 * ld_b + 2 * q;
  const float* s1 = scale + (size_t)ray1 * ld_s + 2 * q;
  const float* b1 = bias + (size_t)ray1 * ld_b + 2 * q;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 sa = __ldg(reinterpret_cast<const float2*>(s0 + 8 * j));
    const float2 ba = __ldg(reinterpret_cast<const float2*>(b0 + 8 * j));
    const float2 sb = __ldg(reinterpret_cast<const float2*>(s1 + 8 * j));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j));
    acc[4 * j] = fmaxf(acc[4 * j] * sa.x + ba.x, 0.0f);
    acc[4 * j + 1] = fmaxf(acc[4 * j + 1] * sa.y + ba.y, 0.0f);
    acc[4 * j + 2] = fmaxf(acc[4 * j + 2] * sb.x + bb.x, 0.0f);
    acc[4 * j + 3] = fmaxf(acc[4 * j + 3] * sb.y + bb.y, 0.0f);
  }
}

// features = acc + b_out for the thread's rows r0 and r0 + 8 of the NO
// accumulator columns, stored where row < n and column < out.
template <int NO>
__device__ __forceinline__ void store_features(const float* acc, const float* __restrict__ b_out,
                                               float* __restrict__ features, int r0, int n, int out, int t) {
  const int q = t & 3;
#pragma unroll
  for (int j = 0; j < NO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
      if (row < n && col < out) features[(size_t)row * out + col] = acc[4 * j + e] + __ldg(b_out + col);
    }
}

template <int W, int NO>
__global__ void __launch_bounds__(kThreads, 1) adain_nerf_kernel(const __grid_constant__ AdaGroup g) {
  constexpr int nb = W / 64;
  static_assert(W == 128 || W == 256, "the feature head's slots take W 128 or 256");
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = aligned_smem(smem_raw);
  const uint32_t act = sm.addr + kStages * kSlotBytes, enc = act + kActBytes, spare = enc + kEncBytes;
  Ring ring;
  init_ring(ring, sm.addr, spare + kEncBytes, kStages, 8 * kCtas);
  if constexpr (kCtas > 1) cluster_sync_all();  // the partner's barriers are initialized
  const int cluster = blockIdx.x / kCtas, clusters = gridDim.x / kCtas;
  const int rank = kCtas > 1 ? (int)cluster_rank() : 0;
  const int backbone_slots = first_slot(g.layers, nb, g.skip);
  const size_t head = (size_t)backbone_slots * 128 * W + 2 * W;  // bytes before W_f0's slots

  if (threadIdx.x >= kConsumers) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int p = cluster; p < g.pairs; p += clusters) {
        const unsigned char* image = g.obj[object_of(g, p)].image;
        for (int s = 0; s < backbone_slots; ++s)
          produce_slot<kStages, kCtas>(ring, image + (size_t)s * 128 * W, 128 * W);
        // W_f0's 2 W/64 slots and W_f1's W/64, each 64 rows x W/2 columns.
        const unsigned char* f = image + head;
        for (int s = 0; s < 3 * nb; ++s) produce_slot<kStages, kCtas>(ring, f + (size_t)s * 64 * W, 64 * W);
        const unsigned char* out = f + (size_t)3 * nb * 64 * W;
        for (int s = 0; s < nb / 2; ++s) produce_slot<kStages, kCtas>(ring, out + (size_t)s * 128 * NO, 128 * NO);
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t & 31, q = lane & 3;
    unsigned char* act_p = sm.base + kStages * kSlotBytes;
    unsigned char* enc_p = act_p + kActBytes;
    unsigned char* spare_p = enc_p + kEncBytes;
    float acc[(W > NO ? W : NO) / 2];
    auto act_block = [&](int j) { return act + j * kTile * 128; };
    // f0's output, 64-column blocks: the first pass's in the encoding tile
    // (free once the backbone is done) and the spare block, the second's in
    // the activation tile's upper half (free once that pass has read h).
    auto f0_block = [&](int j) { return j < nb / 2 ? (j == 0 ? enc : spare) : act_block(j); };
    for (int p = cluster; p < g.pairs; p += clusters) {
      const int oi = object_of(g, p);
      const AdaObject& o = g.obj[oi];
      const int n = o.n_points;
      const int row0 = ((p - g.pair_start[oi]) * kCtas + rank) * kTile;
      const int r0 = row0 + 64 * wg + 16 * (t >> 5) + (lane >> 2);  // the thread's rows: r0, r0 + 8
      named_sync(1 + wg, 128);  // the previous tile's products are done with the encodings
      load_encoding(o.encoded, enc_p, wg, row0, n, g.pe, t);
      fence_async_smem();
      named_sync(1 + wg, 128);

      for (int i = 0; i < g.layers; ++i) {
        forward_layer<W, kStages, kCtas>(acc, ring, i, g.skip, act, enc, wg, lane);
        bias_relu<W>(acc, o.biases + i * W, t);
        if (i + 1 == g.layers) {
          // alpha = bf16(h) . bf16(w_alpha) + b_alpha.
          const bf16* w_alpha = reinterpret_cast<const bf16*>(o.image + (size_t)backbone_slots * 128 * W);
          const float b_alpha = __ldg(o.biases + g.layers * W);
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int j = 0; j < W / 8; ++j) {
            const int col = 8 * j + 2 * q;
            const float wa0 = __bfloat162float(w_alpha[col]), wa1 = __bfloat162float(w_alpha[col + 1]);
            s0 += __bfloat162float(__float2bfloat16(acc[4 * j])) * wa0 +
                  __bfloat162float(__float2bfloat16(acc[4 * j + 1])) * wa1;
            s1 += __bfloat162float(__float2bfloat16(acc[4 * j + 2])) * wa0 +
                  __bfloat162float(__float2bfloat16(acc[4 * j + 3])) * wa1;
          }
          s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
          s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          if (q == 0 && r0 < n) o.alpha[r0] = s0 + b_alpha;
          if (q == 0 && r0 + 8 < n) o.alpha[r0 + 8] = s1 + b_alpha;
        }
        named_sync(1 + wg, 128);  // every warp's products have read the tile
        store_tile<W>(act_p, acc, wg, t);
        fence_async_smem();
        named_sync(1 + wg, 128);
      }

      // The feature head. Rows past the object's end read the last ray's
      // modulation and are not stored. f0 runs in two passes of W/2
      // columns, so that no epilogue holds a W-column accumulator beside
      // its modulation loads (which spills); the first pass cannot write
      // into the activation tile, which the second still reads.
      const int ray0 = min(r0, n - 1) / o.samples, ray1 = min(r0 + 8, n - 1) / o.samples;
      head_layer<W / 2, nb>(acc, ring, act_block, wg, lane);
      modulate_relu<W / 2>(acc, o.mod[0], o.ld[0], o.mod[1], o.ld[1], ray0, ray1, t);
      store_tile<64>(enc_p, acc, wg, t);
      if constexpr (W == 256) store_tile<64>(spare_p, acc + 32, wg, t);
      head_layer<W / 2, nb>(acc, ring, act_block, wg, lane);
      modulate_relu<W / 2>(acc, o.mod[0] + W / 2, o.ld[0], o.mod[1] + W / 2, o.ld[1], ray0, ray1, t);
      named_sync(1 + wg, 128);
      store_tile<W / 2>(act_p, acc, wg, t, W / 2);
      fence_async_smem();
      named_sync(1 + wg, 128);

      head_layer<W / 2, nb>(acc, ring, f0_block, wg, lane);
      modulate_relu<W / 2>(acc, o.mod[2], o.ld[2], o.mod[3], o.ld[3], ray0, ray1, t);
      store_tile<W / 2>(act_p, acc, wg, t);  // into h's first half, read by no product since f0
      fence_async_smem();
      named_sync(1 + wg, 128);

      head_layer<NO, nb / 2>(acc, ring, act_block, wg, lane);
      store_features<NO>(acc, o.biases + g.layers * W + 1, o.features, r0, n, g.out, t);
    }
  }
  if constexpr (kCtas > 1) cluster_sync_all();  // no CTA leaves while its partner can still reach its ring
}

// ---- host side -------------------------------------------------------------------

// Raises the kernel's dynamic shared-memory limit once per process and
// device (the current one, on which it launches) and returns how many of
// its clusters the card places at once.
template <int W, int NO>
cudaError_t prepare(int* clusters) {
  constexpr int kMaxDevices = 64;
  static int max_clusters[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (max_clusters[device] == 0) {
    e = cudaFuncSetAttribute(adain_nerf_kernel<W, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return e;
    int n = 0;
    if constexpr (kCtas == 1) {
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adain_nerf_kernel<W, NO>, kThreads, kSmem);
      n = sms * per_sm;
    } else {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = kCtas;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(kCtas);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = kSmem;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&n, adain_nerf_kernel<W, NO>, &cfg);
    }
    if (e != cudaSuccess) return e;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    max_clusters[device] = n;
  }
  *clusters = max_clusters[device];
  return cudaSuccess;
}

template <int W, int NO>
int launch(const AdaGroup& g, cudaStream_t stream) {
  int clusters = 0;
  cudaError_t e = prepare<W, NO>(&clusters);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCtas * min(clusters, g.pairs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = kCtas > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, adain_nerf_kernel<W, NO>, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiated (width, outputs rounded up to 64): F(W, NO) for each.
#define ADAIN_SHAPES(F) \
  F(128, 64) F(128, 128) F(128, 192) F(128, 256) F(256, 64) F(256, 128) F(256, 192) F(256, 256)

}  // namespace

// CTAs per cluster, the tiles of one entry of the pair table.
extern "C" int fused_adain_nerf_cluster_size() { return kCtas; }

// How many clusters of the kernel for (width, out) the current device places
// at once (the launch's grid), or minus a CUDA error code.
extern "C" int fused_adain_nerf_max_clusters(int width, int out) {
  const int no = (out + 63) / 64 * 64;
  int clusters = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define PREPARE(W, NO) \
  if (width == W && no == NO) e = prepare<W, NO>(&clusters);
  ADAIN_SHAPES(PREPARE)
#undef PREPARE
  return e == cudaSuccess ? clusters : -(int)e;
}

// One launch over `objects` objects (at most 16) of one MLP configuration
// on `stream`; returns the CUDA error code (0 on success). Per object o:
// ptrs[9 o .. 9 o + 8] = encoded (bf16), scale0, bias0, scale1, bias1 (f32,
// per ray, each row's columns contiguous), the weight image, the biases,
// features and alpha (f32 outputs); ints[6 o .. 6 o + 5] = points, samples
// per ray and the four modulation arrays' row strides. pair_start[0 ..
// objects] is the pair prefix table (ops/fused_nerf.py::adain_pair_table).
// Shapes and limits (width 128 or 256, pe <= 64, out <= 256, 0 < skip) are
// checked by the Python wrapper, which allocates every buffer.
extern "C" int fused_adain_nerf_group_launch(int objects, const void* const* ptrs, const int* ints,
                                             const int* pair_start, int pe, int width, int layers, int skip, int out,
                                             void* stream) {
  if (objects < 1 || objects > kMaxObjects) return (int)cudaErrorInvalidValue;
  AdaGroup g = {};
  g.objects = objects;
  g.pairs = pair_start[objects];
  g.pe = pe;
  g.layers = layers;
  g.skip = skip;
  g.out = out;
  for (int o = 0; o <= objects; ++o) g.pair_start[o] = pair_start[o];
  for (int o = 0; o < objects; ++o) {
    const void* const* p = ptrs + 9 * o;
    AdaObject& a = g.obj[o];
    a.encoded = (const bf16*)p[0];
    for (int m = 0; m < 4; ++m) a.mod[m] = (const float*)p[1 + m];
    a.image = (const unsigned char*)p[5];
    a.biases = (const float*)p[6];
    a.features = (float*)p[7];
    a.alpha = (float*)p[8];
    a.n_points = ints[6 * o];
    a.samples = ints[6 * o + 1];
    for (int m = 0; m < 4; ++m) a.ld[m] = ints[6 * o + 2 + m];
  }
  if (g.pairs == 0) return 0;
  const int no = (out + 63) / 64 * 64;
#define LAUNCH(W, NO) \
  if (width == W && no == NO) return launch<W, NO>(g, (cudaStream_t)stream);
  ADAIN_SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
