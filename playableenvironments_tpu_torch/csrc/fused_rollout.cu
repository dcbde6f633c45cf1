// The phase-3 dynamics rollout for Hopper (sm_90a): forward (B4) and
// backward (B5), f32 throughout.
//
// Replaces the TPU kernels playableenvironments_tpu/ops/fused_rollout_pallas.py::
// forward (the whole T-1-step teacher-forced LSTM rollout in one kernel,
// optionally emitting per-step residuals) and ::backward (reverse-time BPTT
// from those residuals). Each step: the input state is the ground truth
// while t < gt_count, else the previous prediction; sin/cos(rotations) ++
// translations / box ++ style ++ deformation ++ action ++ variation feed L
// LSTM cells (gates i, f, g, o; bias-free input projections); a ReLU
// backbone and a head give the rotation delta (the JAX core's atan formula,
// not atan2f: they differ at c = 0 and s = -0.0), the translation delta
// rotated to world, the style and the deformation. The math is that of
// playableenvironments_tpu/ops/fused_rollout.py::_step_forward and
// _step_backward.
//
// Bound and pace. At the tennis phase-3 shape (16 rows, T 9, F 256, 2
// layers, 117 inputs, head 105) a launch is 255.6 MFLOP forward, about
// twice that backward, and ~6-10 MB of weights, residuals and I/O: ~4-8 us
// at the card's f32 peak or memory rate. But the T-1 steps are serial, and
// each step is a chain of dependent products over only 16 rows, each of
// which reads ~1 M weights (4 MB). On one SM that chain waits on L2 latency
// (the first version of this file: ~0.4 ms a step). So one 16-row tile runs
// on a thread-block cluster of n CTAs (16 where F is a multiple of 64, else
// 8; a non-portable size), and what sets the pace is each CTA's share of
// the products (~1 M FFMA a step at n 16: ~5 us at the SM's f32 rate, run
// at ~40% of it) beside the cluster-wide exchanges (L + 2 a step forward,
// 2 L + 1 backward, ~1 us each with the skew between CTAs) and the step's
// small serial work, not operations or bytes of the whole card.
//
// Split by hidden unit. CTA q of a cluster owns hidden units
// [q U, (q + 1) U), U = F / n, of all four gates of every layer: it forms
// i, f, g, o, c and h for its units alone (gates are never exchanged) and
// writes its slice of h into every CTA's shared memory (distributed shared
// memory, st.shared::cluster). The backbone splits the same way by column
// and broadcasts y; the head splits by column (HU = ceil(H / n) columns,
// rounded up to 4) and broadcasts its slice; every CTA then forms the next
// state redundantly (16 rows, a few columns). An exchange is a cluster-wide
// barrier among the consumer threads only (the producer warp runs on): they
// meet at a named barrier, thread p arrives (release, cluster scope) on CTA
// p's exchange mbarrier, and all wait (acquire, cluster scope) until the n
// CTAs have arrived. Carries of h are double-buffered by step parity, so a
// CTA that runs ahead never overwrites an h another CTA still reads; a
// layer's h_prev product, which needs no new h, runs between its CTA's
// arrival and its wait on the layer below.
//
// Weights. The launchers first gather a per-call weight image on the card
// (rollout_image_kernel; its plain versions are ops/fused_rollout.py::
// rollout_fwd_image / rollout_bwd_image): for each CTA a contiguous run of
// segments, each K rows of W floats, k-major, in the order the CTA consumes
// them. A producer warp streams the CTA's run once per step through a ring
// of 16 KB slots in shared memory with cp.async.bulk, completing on
// mbarriers, so each weight element is read once a step and the next
// segment is in flight while a CTA waits on an exchange. The products: 256
// consumer threads, each a 4 x 4 tile of the (16 rows, W columns) output
// for one of G = 256 / W groups of k; a k row of the activations (16 rows
// contiguous, k-major) and of the weights are two 16-byte loads for 16
// FFMA. The groups' partials are summed in a fixed order, so every result
// is the same from run to run. The step's global inputs (ground truth,
// actions, residuals) are copied into shared memory with cp.async a step
// ahead.
//
// Forward (rollout_fwd_kernel), per step: the input block (every CTA); per
// layer the gate product over [h_prev | x_in] (W = 4U, gate-interleaved
// columns u * 4 + gate) and the cell, then the h exchange; the backbone
// (W = U), the y exchange; the head (W = HU), the head exchange; the next
// state. Residuals go to global memory in the JAX layout (T-1, B, .), each
// CTA its own columns and its share of the rows, only when asked.
//
// Backward, two kernels:
// (a) rollout_bwd_recurrence_kernel, on the same clusters: the serial
//     reverse chain. Every CTA forms d_head (16 rows) redundantly; d_y for
//     its own backbone columns (d_head whead[own]^T, masked by y > 0),
//     exchanged; d_h of the top layer for its own units (d_y wb[own]^T);
//     per layer, top down, dz for its own units, exchanged (all 4F columns),
//     then one product over dz (W = U + U, or U + XU on layer 0) gives its
//     own units of d_h_prev = dz wh^T and of d_x = dz wx^T, or its XU
//     columns of the input gradient, exchanged. Every sum over units is thus
//     formed whole in one CTA, in a fixed order: no partial sums cross
//     CTAs, no atomics. A guard exchange between layers keeps a CTA from
//     overwriting dz while another still reads it.
//     It writes each layer's dz (T-1, B, 4F), d_y (T-1, B, F) and d_head
//     (T-1, B, H) to scratch, the state, action and variation gradients to
//     their outputs, and the tile's final d_h and d_c.
// (b) rollout_wgrad_kernel: every parameter gradient over all (T-1) B rows
//     at once, g_wx = X^T dZ, g_wh = Hprev^T dZ (Hprev's first B rows are
//     h_init), g_wb = H_top^T dY, g_whead = Y^T dHead, and the bias and
//     initial-carry gradients as column sums (a column of ones as X). Many
//     CTAs, each owning a 32 x 32 output tile and summing its rows in index
//     order: no atomics, so the gradients are bit-identical run to run. The
//     TPU kernel instead +=s ~4 MB of gradients into its outputs at every
//     step of a sequential grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;           // batch rows per cluster
constexpr int kConsumers = 256;     // compute threads per CTA
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxLayers = 4;
constexpr int kSlotFloats = 4096;   // one ring slot: 16 KB
constexpr int kMaxStages = 8;
constexpr int kPartFloats = kConsumers * kTile;  // k-group partials
static_assert(kConsumers == 16 * kTile, "the prefetches give each tile row sixteen threads");
constexpr int kBarBytes = (2 * kMaxStages + 1) * 8;
constexpr int kMaxSegs = 2 * kMaxLayers + 2;
constexpr int kGradTile = 32;  // weight-gradient output tile edge
constexpr int kGradThreads = 256;
constexpr int kMaxJobs = 5 * kMaxLayers + 4;

struct Dims {
  int batch, T, F, L, S, D, A, V, in0, H, SW, gt_count, axis, force_rot, force_axis;
  float axis_value, inv_box[3];
  // CTAs per cluster, hidden units, head columns and input columns per CTA,
  // ring slots.
  int n, U, HU, XU, stages;
};

// The weight image of one CTA: segments of K rows of W floats, in order.
struct Segments {
  int K[kMaxSegs], W[kMaxSegs], offset[kMaxSegs], count, per_cta;
  __host__ __device__ void add(int k, int w) {
    K[count] = k;
    W[count] = w;
    offset[count++] = per_cta;
    per_cta += k * w;
  }
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

inline Segments forward_segments(const Dims& d) {
  Segments s = {};
  for (int l = 0; l < d.L; ++l) {
    s.add(d.F, 4 * d.U);                   // wh_l
    s.add(l == 0 ? d.in0 : d.F, 4 * d.U);  // wx_l
  }
  s.add(d.F, d.U);
  s.add(d.F, d.HU);
  return s;
}

inline Segments backward_segments(const Dims& d) {
  Segments s = {};
  s.add(d.H, d.U);
  s.add(d.F, d.U);
  for (int l = d.L - 1; l >= 0; --l) s.add(4 * d.F, d.U + (l > 0 ? d.U : d.XU));
  return s;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Width of one row of the backward's prefetched residuals: cur_rot (3),
// head's first 9 columns, y (U), per layer gates (4U), c (U) and c_prev (U)
// of this CTA's units, and the cotangents entering the step's outputs (SW).
__host__ __device__ inline int bwd_prefetch_width(const Dims& d) { return round4(12 + d.U + 6 * d.L * d.U + d.SW); }

// Shared memory, in floats from the start (the ring first, 128-byte
// aligned); ops/fused_rollout.py::_smem_bytes mirrors the totals.
struct FwdSmem {
  int part, hs, y, head, x0, state, in, stage, cs, bias, bars, bytes;
};

__host__ __device__ inline FwdSmem fwd_smem(const Dims& d) {
  FwdSmem m;
  m.part = d.stages * kSlotFloats;             // k-group partials
  m.hs = m.part + kPartFloats;                 // [2][L][F][16]
  m.y = m.hs + 2 * d.L * d.F * kTile;          // [F][16]
  m.head = m.y + d.F * kTile;                  // [n HU][16]
  m.x0 = m.head + d.n * d.HU * kTile;          // [in0][16]
  m.state = m.x0 + d.in0 * kTile;              // [16][SW]
  m.in = m.state + round4(kTile * d.SW);       // [16][SW + A + V]: the next step's inputs
  m.stage = m.in + round4(kTile * (d.SW + d.A + d.V));  // [U or HU][16]
  m.cs = m.stage + kTile * imax(d.U, d.HU);    // [L][U][16]
  m.bias = m.cs + d.L * d.U * kTile;           // [L][4U] | [U] | [HU]
  m.bars = m.bias + round4(d.L * 4 * d.U + d.U + d.HU);
  m.bytes = 4 * m.bars + kBarBytes;
  return m;
}

struct BwdSmem {
  int part, dz, dy, dx0, dhead, dstate, dcur, dh, dc, pre, out, stage, bars, bytes;
};

__host__ __device__ inline BwdSmem bwd_smem(const Dims& d) {
  BwdSmem m;
  m.part = d.stages * kSlotFloats;             // k-group partials
  m.dz = m.part + kPartFloats;                 // [4F][16]
  m.dy = m.dz + 4 * d.F * kTile;               // [F][16]
  m.dx0 = m.dy + d.F * kTile;                  // [n XU][16]
  m.dhead = m.dx0 + d.n * d.XU * kTile;        // [H][16]
  m.dstate = m.dhead + d.H * kTile;            // [16][SW]
  m.dcur = m.dstate + round4(kTile * d.SW);    // [16][6]
  m.dh = m.dcur + kTile * 6;                   // [L][U][16]
  m.dc = m.dh + d.L * d.U * kTile;             // [L][U][16]
  m.pre = m.dc + d.L * d.U * kTile;            // [2][16][bwd_prefetch_width]
  m.out = m.pre + 2 * kTile * bwd_prefetch_width(d);  // [16][W]
  m.stage = m.out + kTile * (d.U + imax(d.U, d.XU));
  m.bars = m.stage + kTile * imax(4 * d.U, d.XU);
  m.bytes = 4 * m.bars + kBarBytes;
  return m;
}

// The parameters in param_list order (ops/fused_rollout.py): per layer wx
// (in_l, 4F), wh (F, 4F), bh (4F), h_init (F), c_init (F); then wb (F, F),
// bb (F), whead (F, H), bhead (H); each with its row and column strides in
// elements (a vector's column stride is 1).
struct Params {
  const float* p[5 * kMaxLayers + 4];
  int rs[5 * kMaxLayers + 4], cs[5 * kMaxLayers + 4];
};

__device__ __forceinline__ float at(const Params& w, int i, int row, int col) {
  return w.p[i][(size_t)row * w.rs[i] + (size_t)col * w.cs[i]];
}

// Residuals, each (T-1, B, width): cur_rot, cur_trans, cur_style,
// cur_deform, x0, y, head, then per layer gates (i f g o), c and h.
struct Residuals {
  float* cur[4];
  float* x0;
  float* y;
  float* head;
  float* gates[kMaxLayers];
  float* c[kMaxLayers];
  float* h[kMaxLayers];
};

// The four (B, T or T-1, .) tensors of a state: rotations, translations,
// style, deformation.
template <typename P>
struct State4 {
  P rot, trans, style, deform;
};

// Element `col` of the state row at flat row index `bt` (b T + t).
template <typename P>
__device__ __forceinline__ P state_elem(const State4<P>& s, int col, const Dims& d, size_t bt) {
  if (col < 3) return s.rot + bt * 3 + col;
  if (col < 6) return s.trans + bt * 3 + col - 3;
  if (col < 6 + d.S) return s.style + bt * d.S + col - 6;
  return s.deform + bt * d.D + col - 6 - d.S;
}

// ---- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w)
               : "memory");
}

// Asynchronous copies global -> shared of 4 or 16 bytes, completed by
// cp_async_wait() in the issuing thread.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed (acquire at CTA or
// cluster scope). Traps (a launch error) instead of hanging if a fault
// leaves it waiting 2 s.
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spins = 0;; ++spins) {
    if (kCluster)
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if ((spins & 1023u) == 1023u) {
      const uint64_t now = global_ns();
      if (start == 0)
        start = now;
      else if (now - start > 2000000000ull)
        __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrives on an mbarrier of any CTA of the cluster, releasing at cluster
// scope what this thread's CTA ordered before it (see exchange()).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote_bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Every thread of every CTA of the cluster (producers included).
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// The consumer threads of this CTA (named barrier 1; __syncthreads is 0).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ---- the weight ring ------------------------------------------------------------

// A position in the ring of `stages` slots of kSlotFloats; full[s] and
// empty[s] mbarriers at +8 s.
struct Ring {
  const float* slots;
  uint32_t slots_u32, full, empty;
  int stages, slot, phase;
  __device__ __forceinline__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ Ring make_ring(float* smem, int bars_float, int stages) {
  Ring r;
  r.slots = smem;
  r.slots_u32 = smem_u32(smem);
  r.full = smem_u32(smem + bars_float);
  r.empty = r.full + 8 * kMaxStages;
  r.stages = stages;
  r.slot = 0;
  r.phase = 0;
  return r;
}

__device__ __forceinline__ uint32_t exchange_bar(const Ring& r) { return r.empty + 8 * kMaxStages; }

// The producer: one thread streams this CTA's image, segment by segment,
// `steps` times, in chunks of kSlotFloats / W whole rows; a slot is refilled
// once every consumer warp has released it.
__device__ __forceinline__ void produce(Ring& r, const float* __restrict__ image, const Segments& seg, int steps) {
  for (int t = 0; t < steps; ++t) {
    const float* src = image;
    for (int s = 0; s < seg.count; ++s) {
      const int K = seg.K[s], W = seg.W[s], R = kSlotFloats / W;
      for (int k0 = 0; k0 < K; k0 += R) {
        const uint32_t bytes = 4u * (uint32_t)(min(R, K - k0) * W);
        mbar_wait<false>(r.empty + 8 * r.slot, r.phase ^ 1);
        mbar_expect_tx(r.full + 8 * r.slot, bytes);
        bulk_load(r.slots_u32 + 4u * r.slot * kSlotFloats, src + (size_t)k0 * W, bytes, r.full + 8 * r.slot);
        r.advance();
      }
      src += (size_t)K * W;
    }
  }
}

// A consumer thread's place in a (16 rows, W columns) product: a 4 x 4
// output tile (rows 4 row .. +3, columns 4 col .. +3) for k-group g of G.
// Neighbouring lanes take neighbouring tiles, so that a warp's loads of a
// weight row fall in distinct banks.
struct Tile {
  int g, G, row, col;
  bool active;
};

__device__ __forceinline__ Tile tile_of(int W) {
  Tile t;
  const int tiles = W;  // (16 / 4) x (W / 4)
  const int i = threadIdx.x % tiles;
  t.G = kConsumers / tiles;
  t.g = threadIdx.x / tiles;
  t.active = t.g < t.G;
  t.col = i % (W / 4);
  t.row = i / (W / 4);
  return t;
}

// acc += A (k-major [K][16] in shared memory) x the next K x W segment of
// the ring; this thread takes rows k = g, g + G, ... of each chunk.
__device__ __forceinline__ void stream_product(Ring& r, const float* A, int K, int W, const Tile& tl,
                                               float* acc) {
  const int R = kSlotFloats / W;
  for (int k0 = 0; k0 < K; k0 += R) {
    const int rows = min(R, K - k0);
    mbar_wait<false>(r.full + 8 * r.slot, r.phase);
    if (tl.active) {
      const float* w = r.slots + r.slot * kSlotFloats + tl.col * 4;
      const float* a = A + k0 * kTile + tl.row * 4;
#pragma unroll 4
      for (int kk = tl.g; kk < rows; kk += tl.G) {
        const float4 av = *reinterpret_cast<const float4*>(a + kk * kTile);
        const float4 wv = *reinterpret_cast<const float4*>(w + kk * W);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * i] = fmaf(ar[i], wv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(ar[i], wv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(ar[i], wv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(ar[i], wv.w, acc[4 * i + 3]);
        }
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * r.slot);
    r.advance();
  }
}

// Sums the k-groups' partials of the (16 rows, W columns) product in a
// fixed order and hands each run of V columns (row r, columns c .. c + V-1)
// to fn(r, c, sums) in the one thread that owns it: each run is summed by
// S neighbouring lanes (partials g = s, s + S, ... in order, then a fixed
// butterfly), S as many as the runs leave threads for. The caller
// synchronizes the consumers before reading what fn wrote.
template <int V, typename Fn>
__device__ __forceinline__ void reduce_tile(const float* acc, const Tile& tl, int W, float* part, Fn fn) {
  if (tl.active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(part + (tl.g * kTile + tl.row * 4 + i) * W + tl.col * 4) =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  consumer_sync();
  const int outputs = kTile * W, runs = outputs / V;
  int S = 1;
  while (2 * S <= tl.G && 2 * S * runs <= kConsumers && 2 * S <= 32) S *= 2;
  for (int base = 0; base < runs * S; base += kConsumers) {  // the same trip count in every lane of a warp
    const int idx = base + threadIdx.x, o = idx / S, sub = idx % S;
    float sum[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sum[v] = 0.0f;
    if (o < runs) {
      for (int g = sub; g < tl.G; g += S) {
        const float* p = part + g * outputs + o * V;
#pragma unroll
        for (int v = 0; v < V; ++v) sum[v] += p[v];
      }
    }
    for (int m = 1; m < S; m <<= 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) sum[v] += __shfl_xor_sync(0xffffffffu, sum[v], m);
    }
    if (o < runs && sub == 0) fn((o * V) / W, (o * V) % W, sum);
  }
}

__device__ __forceinline__ void zero16(float* acc) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
}

// Copies `floats` (a multiple of 4) from src to dst at the same offset in
// every CTA of the cluster. The caller synchronized the consumers after
// writing src, and calls exchange() next.
__device__ __forceinline__ void broadcast(const float* src, float* dst, int floats, int n) {
  const int vecs = floats / 4;
  const uint32_t base = smem_u32(dst);
  for (int idx = threadIdx.x; idx < vecs * n; idx += kConsumers) {
    const int rank = idx / vecs, i = idx % vecs;
    st_cluster(mapa(base + 16u * i, rank), reinterpret_cast<const float4*>(src)[i]);
  }
}

// A cluster-wide barrier of the consumer threads. The named barrier orders
// every consumer's prior accesses (its broadcasts' remote stores, its reads
// of what the next broadcast overwrites) before thread p's arrive on CTA
// p's exchange mbarrier, which releases them at cluster scope; each thread's
// wait acquires at cluster scope. So on return every CTA's accesses before
// its exchange() are ordered before this CTA's accesses after it.
// Split in two (arrive, then wait), a CTA does work of its own that no
// other CTA writes to in between.
__device__ __forceinline__ void exchange_arrive(uint32_t bar, int n) {
  consumer_sync();
  if ((int)threadIdx.x < n) mbar_arrive_cluster(mapa(bar, threadIdx.x));
}

__device__ __forceinline__ void exchange_wait(uint32_t bar, int& phase) {
  mbar_wait<true>(bar, phase);
  phase ^= 1;
}

__device__ __forceinline__ void exchange(uint32_t bar, int& phase, int n) {
  exchange_arrive(bar, n);
  exchange_wait(bar, phase);
}

// Sets up the ring and exchange barriers, then synchronizes the cluster so
// no CTA arrives on a barrier another has not initialized yet.
__device__ __forceinline__ void init_barriers(const Ring& r, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kConsumers / 32);
    }
    mbar_init(exchange_bar(r), n);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync_all();
}

// ---- the step's small math ------------------------------------------------------

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// R_axis(theta) v, as the reference's _rotate.
__device__ __forceinline__ void rotate(int axis, float c, float s, const float* v, float* out) {
  if (axis == 0) {
    out[0] = v[0];
    out[1] = c * v[1] - s * v[2];
    out[2] = s * v[1] + c * v[2];
  } else if (axis == 1) {
    out[0] = c * v[0] + s * v[2];
    out[1] = v[1];
    out[2] = -s * v[0] + c * v[2];
  } else {
    out[0] = c * v[0] - s * v[1];
    out[1] = s * v[0] + c * v[1];
    out[2] = v[2];
  }
}

// sum(dR/dtheta v * d), as the reference's _rotate_dtheta.
__device__ __forceinline__ float rotate_dtheta(int axis, float c, float s, const float* v, const float* d) {
  float e0, e1, e2;
  if (axis == 0) {
    e0 = 0.0f;
    e1 = -s * v[1] - c * v[2];
    e2 = c * v[1] - s * v[2];
  } else if (axis == 1) {
    e0 = -s * v[0] + c * v[2];
    e1 = 0.0f;
    e2 = -c * v[0] - s * v[2];
  } else {
    e0 = -s * v[0] - c * v[1];
    e1 = c * v[0] - s * v[1];
    e2 = 0.0f;
  }
  return e0 * d[0] + e1 * d[1] + e2 * d[2];
}

// The reference's atan2 from atan (fused_rollout.py::_atan2).
__device__ __forceinline__ float atan2_ref(float s, float c) {
  const float safe_c = fabsf(c) < 1e-20f ? 1e-20f : c;
  const float base = atanf(s / safe_c);
  const float sign_s = s >= 0.0f ? 1.0f : -1.0f;
  return base + (c < 0.0f ? sign_s * 3.14159265358979323846f : 0.0f);
}

// ---- the step's inputs and outputs ----------------------------------------------

// Issues the copies of step t's inputs into `in` ([16][SW + A + V]): the
// ground truth state when the step reads it (t == 0 or t < gt_count), the
// action and the variation; rows past the batch are zeros. Sixteen
// threads share a row.
__device__ __forceinline__ void prefetch_inputs(float* in, const State4<const float*>& gt,
                                                const float* __restrict__ actions,
                                                const float* __restrict__ variations, int b0, int rows, int t,
                                                const Dims& d) {
  const int w = d.SW + d.A + d.V, r = threadIdx.x / 16;
  const bool with_gt = t == 0 || t < d.gt_count;
  float* dst = in + r * w;
  const size_t bt = (size_t)(b0 + r) * (d.T - 1) + t;
  for (int col = with_gt ? threadIdx.x % 16 : d.SW + threadIdx.x % 16; col < w; col += 16) {
    if (r >= rows)
      dst[col] = 0.0f;
    else if (col < d.SW)
      cp_async4(dst + col, state_elem(gt, col, d, (size_t)(b0 + r) * d.T + t));
    else if (col < d.SW + d.A)
      cp_async4(dst + col, actions + bt * d.A + col - d.SW);
    else
      cp_async4(dst + col, variations + bt * d.V + col - d.SW - d.A);
  }
  cp_async_commit();
}

// This CTA's share of a tile's rows: q, q + n, ... below `rows`.
__device__ __forceinline__ int my_rows(int q, int n, int rows) { return q < rows ? (rows - q + n - 1) / n : 0; }

// This CTA's rows of a state block ([16][SW]) -> outputs (B, T, .) at t.
__device__ __forceinline__ void store_state(const float* state, const State4<float*>& out, int b0, int rows, int t, int q,
                            const Dims& d) {
  for (int idx = threadIdx.x; idx < my_rows(q, d.n, rows) * d.SW; idx += kConsumers) {
    const int r = q + (idx / d.SW) * d.n, col = idx % d.SW;
    *state_elem(out, col, d, (size_t)(b0 + r) * d.T + t) = state[r * d.SW + col];
  }
}

// This CTA's rows of a k-major block ([width][16]) -> a residual
// (T-1, B, width) at step t.
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, int width, int t, int b0,
                                           int rows, int q, const Dims& d) {
  float* base = dst + ((size_t)t * d.batch + b0) * width;
  for (int idx = threadIdx.x; idx < my_rows(q, d.n, rows) * width; idx += kConsumers) {
    const int r = q + (idx / width) * d.n, col = idx % width;
    base[(size_t)r * width + col] = src[col * kTile + r];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    rollout_fwd_kernel(const float* __restrict__ image, const float* __restrict__ bias_image,
                       const __grid_constant__ Params w, const __grid_constant__ Residuals res,
                       const __grid_constant__ Dims d, const __grid_constant__ Segments seg, int collect,
                       const __grid_constant__ State4<const float*> gt, const float* __restrict__ actions,
                       const float* __restrict__ variations, const __grid_constant__ State4<float*> outs) {
  extern __shared__ __align__(128) float smem[];
  const int F = d.F, L = d.L, SW = d.SW, in0 = d.in0, H = d.H, B = d.batch, n = d.n, U = d.U, HU = d.HU;
  const int q = (int)cluster_rank();
  const int b0 = (blockIdx.x / n) * kTile;
  const int rows = min(kTile, B - b0);
  const FwdSmem m = fwd_smem(d);
  float* part = smem + m.part;
  float* hs = smem + m.hs;
  float* y = smem + m.y;
  float* head = smem + m.head;
  float* x0 = smem + m.x0;
  float* state = smem + m.state;
  float* in = smem + m.in;
  float* stage = smem + m.stage;
  float* cs = smem + m.cs;
  float* bias = smem + m.bias;
  Ring ring = make_ring(smem, m.bars, d.stages);

  const int nbias = L * 4 * U + U + HU;
  for (int idx = threadIdx.x; idx < L * F * kTile; idx += kThreads)
    hs[idx] = at(w, 5 * (idx / (F * kTile)) + 3, 0, (idx / kTile) % F);  // h_init, step parity 0
  for (int idx = threadIdx.x; idx < L * U * kTile; idx += kThreads)
    cs[idx] = at(w, 5 * (idx / (U * kTile)) + 4, 0, q * U + (idx / kTile) % U);  // c_init
  for (int idx = threadIdx.x; idx < nbias; idx += kThreads) bias[idx] = bias_image[(size_t)q * nbias + idx];
  init_barriers(ring, n);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce(ring, image + (size_t)q * seg.per_cta, seg, d.T - 1);
    }
    __syncwarp();
    cluster_sync_all();
    return;
  }

  const uint32_t xbar = exchange_bar(ring);
  const int in_w = SW + d.A + d.V;
  int phase = 0;
  prefetch_inputs(in, gt, actions, variations, b0, rows, 0, d);
  const Tile gates_tile = tile_of(4 * U);
  float acc[16];
  zero16(acc);
  stream_product(ring, hs, F, 4 * U, gates_tile, acc);  // step 0's layer-0 h_prev wh
  for (int t = 0; t < d.T - 1; ++t) {
    cp_async_wait();
    consumer_sync();
    // The state (the ground truth while the step takes it) and the step's
    // input, k-major: sin/cos pairs, translations / box, style,
    // deformation, action, variation.
    const bool take_gt = t == 0 || t < d.gt_count;
    const float* src = take_gt ? in : state;
    const int src_w = take_gt ? in_w : SW;
    if (take_gt)
      for (int idx = threadIdx.x; idx < kTile * SW; idx += kConsumers) state[idx] = in[(idx / SW) * in_w + idx % SW];
    for (int idx = threadIdx.x; idx < kTile * in0; idx += kConsumers) {
      const int col = idx / kTile, r = idx % kTile;
      const float* s = src + r * src_w;
      float v;
      if (col < 6)
        v = (col & 1) ? cosf(s[col >> 1]) : sinf(s[col >> 1]);
      else if (col < 9)
        v = s[col - 3] * d.inv_box[col - 6];
      else if (col < 9 + d.S + d.D)
        v = s[col - 3];
      else
        v = in[r * in_w + SW + col - 9 - d.S - d.D];
      x0[idx] = v;
    }
    consumer_sync();
    if (t == 0) store_state(state, outs, b0, rows, 0, q, d);
    if (t + 1 < d.T - 1) prefetch_inputs(in, gt, actions, variations, b0, rows, t + 1, d);
    if (collect) {
      // This CTA's rows of the current state and of the input block.
      const State4<float*> cur4 = {res.cur[0], res.cur[1], res.cur[2], res.cur[3]};
      for (int idx = threadIdx.x; idx < my_rows(q, n, rows) * (SW + in0); idx += kConsumers) {
        const int r = q + (idx / (SW + in0)) * n, col = idx % (SW + in0);
        const size_t row = (size_t)t * B + b0 + r;
        if (col < SW)
          *state_elem(cur4, col, d, row) = state[r * SW + col];
        else
          res.x0[row * in0 + col - SW] = x0[(col - SW) * kTile + r];
      }
    }

    // Layer l's gates: h_prev wh (old h, formed while the cluster exchanges
    // layer l-1's new h; layer 0's at the end of the previous step), then
    // x_in wx.
    const int cur = t & 1, nxt = cur ^ 1;
    for (int l = 0; l < L; ++l) {
      if (l > 0) {
        zero16(acc);
        stream_product(ring, hs + (cur * L + l) * F * kTile, F, 4 * U, gates_tile, acc);
        exchange_wait(xbar, phase);
      }
      stream_product(ring, l == 0 ? x0 : hs + (nxt * L + l - 1) * F * kTile, l == 0 ? in0 : F, 4 * U, gates_tile,
                     acc);
      const Tile& tl = gates_tile;
      // The cell on this CTA's units, from the gate columns u * 4 + gate.
      reduce_tile<4>(acc, tl, 4 * U, part, [&](int r, int c, const float* z) {
        const int u = c / 4, j = q * U + u;
        const float* b = bias + l * 4 * U + c;
        const float i = sigmoidf(z[0] + b[0]);
        const float f = sigmoidf(z[1] + b[1]);
        const float g = tanhf(z[2] + b[2]);
        const float o = sigmoidf(z[3] + b[3]);
        float* cell = cs + (l * U + u) * kTile + r;
        const float c_new = f * *cell + i * g;
        const float h_new = o * tanhf(c_new);
        *cell = c_new;
        stage[u * kTile + r] = h_new;
        if (collect && r < rows) {
          const size_t row = (size_t)t * B + b0 + r;
          float* gates = res.gates[l] + row * 4 * F;
          gates[j] = i;
          gates[F + j] = f;
          gates[2 * F + j] = g;
          gates[3 * F + j] = o;
          res.c[l][row * F + j] = c_new;
          res.h[l][row * F + j] = h_new;
        }
      });
      consumer_sync();
      broadcast(stage, hs + ((nxt * L + l) * F + q * U) * kTile, U * kTile, n);
      exchange_arrive(xbar, n);
    }
    exchange_wait(xbar, phase);

    // Backbone, this CTA's columns of y.
    {
      const Tile tl = tile_of(U);
      zero16(acc);
      stream_product(ring, hs + (nxt * L + L - 1) * F * kTile, F, U, tl, acc);
      reduce_tile<1>(acc, tl, U, part, [&](int r, int u, const float* v) {
        const float y_ru = fmaxf(v[0] + bias[L * 4 * U + u], 0.0f);
        stage[u * kTile + r] = y_ru;
        if (collect && r < rows) res.y[((size_t)t * B + b0 + r) * F + q * U + u] = y_ru;
      });
      consumer_sync();
      broadcast(stage, y + q * U * kTile, U * kTile, n);
      exchange(xbar, phase, n);
    }
    // Head, this CTA's HU columns (those past H are zero weights).
    {
      const Tile tl = tile_of(HU);
      zero16(acc);
      stream_product(ring, y, F, HU, tl, acc);
      reduce_tile<1>(acc, tl, HU, part, [&](int r, int c, const float* v) {
        const int col = q * HU + c;
        const float value = v[0] + bias[L * 4 * U + U + c];
        stage[c * kTile + r] = value;
        if (collect && r < rows && col < H) res.head[((size_t)t * B + b0 + r) * H + col] = value;
      });
      consumer_sync();
      broadcast(stage, head + q * HU * kTile, HU * kTile, n);
      exchange_arrive(xbar, n);
      if (t + 1 < d.T - 1) {  // the next step's layer-0 h_prev wh, from this step's h
        zero16(acc);
        stream_product(ring, hs + nxt * L * F * kTile, F, 4 * U, gates_tile, acc);
      }
      exchange_wait(xbar, phase);
    }

    // The next state, in every CTA: rotation delta on the axis, translation
    // delta rotated to world by the current angle (its sine and cosine are
    // the step input's), style and deformation from the head.
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x, ax = d.axis;
      float* s = state + r * SW;
      float delta[3], world[3];
      for (int k = 0; k < 3; ++k) delta[k] = head[(6 + k) * kTile + r];
      rotate(ax, x0[(2 * ax + 1) * kTile + r], x0[2 * ax * kTile + r], delta, world);
      if (!d.force_rot) s[ax] = s[ax] + atan2_ref(head[2 * ax * kTile + r], head[(2 * ax + 1) * kTile + r]);
      for (int k = 0; k < 3; ++k) s[3 + k] = s[3 + k] + world[k];
      if (d.force_axis) s[3 + ax] = d.axis_value;
    }
    for (int idx = threadIdx.x; idx < kTile * (d.S + d.D); idx += kConsumers) {
      const int r = idx / (d.S + d.D), j = idx % (d.S + d.D);
      state[r * SW + 6 + j] = head[(9 + j) * kTile + r];
    }
    consumer_sync();
    store_state(state, outs, b0, rows, t + 1, q, d);
  }
  cluster_sync_all();
}

// Issues the copies of the residuals step t of the backward reads into
// `pre` ([16][bwd_prefetch_width], row layout in bwd_prefetch_width); rows
// past the batch are zeros. Sixteen threads share a row.
__device__ __forceinline__ void prefetch_residuals(float* pre, const Residuals& res, const Params& w,
                                                   const State4<const float*>& cot, int b0, int rows, int t, int q,
                                                   const Dims& d) {
  const int U = d.U, F = d.F, v4 = U / 4, r = threadIdx.x / 16, j16 = threadIdx.x % 16;
  const size_t row = (size_t)t * d.batch + b0 + r;
  float* dst_row = pre + r * bwd_prefetch_width(d);
  // 16-byte pieces: y, then per layer gates i f g o, c and c_prev of this CTA's units.
  for (int p = j16; p < (1 + 6 * d.L) * v4; p += 16) {
    const int piece = p / v4, j = q * U + (p % v4) * 4;
    float* dst = dst_row + 12 + piece * U + (p % v4) * 4;
    const int l = (piece - 1) / 6, k = (piece - 1) % 6;
    if (r >= rows)
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    else if (piece == 0)
      cp_async16(dst, res.y + row * F + j);
    else if (k < 4)
      cp_async16(dst, res.gates[l] + row * 4 * F + k * F + j);
    else if (k == 4)
      cp_async16(dst, res.c[l] + row * F + j);
    else if (t > 0)
      cp_async16(dst, res.c[l] + (row - d.batch) * F + j);
    else
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, w.p[5 * l + 4] + j + e);  // c_init
  }
  // 4-byte pieces: cur_rot, head[0:9], the cotangents at t + 1.
  for (int i = j16; i < 12 + d.SW; i += 16) {
    float* dst = dst_row + (i < 12 ? i : 12 + U * (1 + 6 * d.L) + i - 12);
    if (r >= rows)
      *dst = 0.0f;
    else if (i < 3)
      cp_async4(dst, res.cur[0] + row * 3 + i);
    else if (i < 12)
      cp_async4(dst, res.head + row * d.H + i - 3);
    else
      cp_async4(dst, state_elem(cot, i - 12, d, (size_t)(b0 + r) * d.T + t + 1));
  }
  cp_async_commit();
}

// (a) The serial reverse chain, on the forward's clusters.
__global__ void __launch_bounds__(kThreads, 1)
    rollout_bwd_recurrence_kernel(const float* __restrict__ image, const __grid_constant__ Params w,
                                  const __grid_constant__ Residuals res, const __grid_constant__ Dims d,
                                  const __grid_constant__ Segments seg, const __grid_constant__ State4<const float*> cot,
                                  const __grid_constant__ State4<float*> g_state, float* __restrict__ g_actions,
                                  float* __restrict__ g_variations, float* __restrict__ dz_out,
                                  float* __restrict__ dy_out, float* __restrict__ dhead_out,
                                  float* __restrict__ d_final) {
  extern __shared__ __align__(128) float smem[];
  const int F = d.F, L = d.L, SW = d.SW, H = d.H, B = d.batch, T = d.T, n = d.n, U = d.U, XU = d.XU;
  const int q = (int)cluster_rank();
  const int b0 = (blockIdx.x / n) * kTile;
  const int rows = min(kTile, B - b0);
  const BwdSmem m = bwd_smem(d);
  const int PW = bwd_prefetch_width(d);
  float* part = smem + m.part;
  float* dz_all = smem + m.dz;
  float* dy_all = smem + m.dy;
  float* dx0_all = smem + m.dx0;
  float* dhead = smem + m.dhead;
  float* dstate = smem + m.dstate;
  float* dcur = smem + m.dcur;
  float* dh = smem + m.dh;
  float* dc = smem + m.dc;
  float* out = smem + m.out;
  float* stage = smem + m.stage;
  Ring ring = make_ring(smem, m.bars, d.stages);

  for (int idx = threadIdx.x; idx < 2 * L * U * kTile; idx += kThreads) dh[idx] = 0.0f;  // dh and dc
  for (int idx = threadIdx.x; idx < kTile * SW; idx += kThreads) dstate[idx] = 0.0f;
  init_barriers(ring, n);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce(ring, image + (size_t)q * seg.per_cta, seg, T - 1);
    }
    __syncwarp();
    cluster_sync_all();
    return;
  }

  const uint32_t xbar = exchange_bar(ring);
  int phase = 0;
  float acc[16];
  prefetch_residuals(smem + m.pre + ((T - 2) & 1) * kTile * PW, res, w, cot, b0, rows, T - 2, q, d);
  for (int t = T - 2; t >= 0; --t) {
    const float* pre = smem + m.pre + (t & 1) * kTile * PW;  // this step's residuals, row r at r PW
    cp_async_wait();
    consumer_sync();
    if (t > 0) prefetch_residuals(smem + m.pre + ((t - 1) & 1) * kTile * PW, res, w, cot, b0, rows, t - 1, q, d);
    // The gradient entering the step's outputs: the chain plus the loss's.
    for (int idx = threadIdx.x; idx < kTile * SW; idx += kConsumers)
      dstate[idx] = dstate[idx] + pre[(idx / SW) * PW + 12 + U * (1 + 6 * L) + idx % SW];
    consumer_sync();

    // d_head (k-major), in every CTA.
    const size_t row0 = (size_t)t * B + b0;
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x, ax = d.axis;
      const float* ds = dstate + r * SW;
      const float* pr = pre + r * PW;  // cur_rot 0..2, head 3..11
      float* dcr = dcur + r * 6;
      float d_sum[3], delta[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d_sum[k] = (d.force_axis && k == ax) ? 0.0f : ds[3 + k];
        delta[k] = pr[3 + 6 + k];
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) dhead[k * kTile + r] = 0.0f;
      if (!d.force_rot) {
        const float s_a = pr[3 + 2 * ax], c_a = pr[3 + 2 * ax + 1];
        const float denom = s_a * s_a + c_a * c_a + 1e-20f;
        dhead[2 * ax * kTile + r] = ds[ax] * c_a / denom;
        dhead[(2 * ax + 1) * kTile + r] = -ds[ax] * s_a / denom;
      }
      const float ct = cosf(pr[ax]), st = sinf(pr[ax]);
      float d_delta[3];
      rotate(ax, ct, -st, d_sum, d_delta);  // R^T = R(-theta)
      const float d_theta = rotate_dtheta(ax, ct, st, delta, d_sum);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dcr[k] = k == ax ? ds[k] + d_theta : ds[k] + 0.0f;
        dcr[3 + k] = d_sum[k];
        dhead[(6 + k) * kTile + r] = d_delta[k];
      }
    }
    for (int idx = threadIdx.x; idx < kTile * (d.S + d.D); idx += kConsumers) {
      const int r = idx / (d.S + d.D), j = idx % (d.S + d.D);
      dhead[(9 + j) * kTile + r] = dstate[r * SW + 6 + j];
    }
    consumer_sync();
    store_rows(dhead_out, dhead, H, t, b0, rows, q, d);

    // d_y on this CTA's backbone columns: d_head whead^T masked by y > 0.
    {
      const Tile tl = tile_of(U);
      zero16(acc);
      stream_product(ring, dhead, H, U, tl, acc);
      reduce_tile<1>(acc, tl, U, part, [&](int r, int u, const float* v) {
        const float dy_ru = v[0] * (pre[r * PW + 12 + u] > 0.0f ? 1.0f : 0.0f);
        stage[u * kTile + r] = dy_ru;
        if (r < rows) dy_out[(row0 + r) * F + q * U + u] = dy_ru;
      });
      consumer_sync();
      broadcast(stage, dy_all + q * U * kTile, U * kTile, n);
      exchange(xbar, phase, n);
    }
    // d_h of the top layer on this CTA's units: d_y wb^T.
    {
      const Tile tl = tile_of(U);
      zero16(acc);
      stream_product(ring, dy_all, F, U, tl, acc);
      reduce_tile<1>(acc, tl, U, part, [&](int r, int u, const float* v) { out[r * U + u] = v[0]; });
    }
    const float* dx_in = out;  // [16][dx_ld]: the gradient reaching this layer's h
    int dx_ld = U;

    // LSTM layers, top down.
    for (int l = L - 1; l >= 0; --l) {
      if (l < L - 1)
        exchange(xbar, phase, n);  // every CTA is done reading dz_all
      else
        consumer_sync();
      for (int idx = threadIdx.x; idx < U * kTile; idx += kConsumers) {
        const int u = idx / kTile, r = idx % kTile, j = q * U + u;
        const float* pl = pre + r * PW + 12 + (1 + 6 * l) * U + u;  // gates, c, c_prev at U strides
        const float i = pl[0], f = pl[U], g = pl[2 * U], o = pl[3 * U], c_new = pl[4 * U], c_prev = pl[5 * U];
        const float tanh_c = tanhf(c_new);
        float* dh_l = dh + (l * U + u) * kTile + r;
        float* dc_l = dc + (l * U + u) * kTile + r;
        const float d_h = dx_in[r * dx_ld + u] + *dh_l;
        const float d_o = d_h * tanh_c;
        const float d_c = *dc_l + d_h * o * (1.0f - tanh_c * tanh_c);
        const float d_f = d_c * c_prev;
        const float d_i = d_c * g;
        const float d_g = d_c * i;
        *dc_l = d_c * f;
        const float dz[4] = {d_i * i * (1.0f - i), d_f * f * (1.0f - f), d_g * (1.0f - g * g), d_o * o * (1.0f - o)};
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          stage[(gate * U + u) * kTile + r] = dz[gate];
          if (r < rows) dz_out[((size_t)l * (T - 1) * B + row0 + r) * 4 * F + gate * F + j] = dz[gate];
        }
      }
      consumer_sync();
      for (int gate = 0; gate < 4; ++gate)
        broadcast(stage + gate * U * kTile, dz_all + (gate * F + q * U) * kTile, U * kTile, n);
      exchange(xbar, phase, n);

      // One product over dz: [d_h_prev of this CTA's units | d_x of its
      // units, or of its XU input columns on layer 0].
      const int W = U + (l > 0 ? U : XU);
      const Tile tl = tile_of(W);
      zero16(acc);
      stream_product(ring, dz_all, 4 * F, W, tl, acc);
      reduce_tile<1>(acc, tl, W, part, [&](int r, int c, const float* v) {
        if (c < U)
          dh[(l * U + c) * kTile + r] = v[0];
        else if (l > 0)
          out[r * W + c] = v[0];
        else
          stage[(c - U) * kTile + r] = v[0];
      });
      dx_in = out + U;
      dx_ld = W;
    }
    consumer_sync();
    broadcast(stage, dx0_all + q * XU * kTile, XU * kTile, n);
    exchange(xbar, phase, n);

    // The input assembly: sin/cos and box scaling back to the state.
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      float* dcr = dcur + r * 6;
      for (int k = 0; k < 3; ++k) {
        const float angle = pre[r * PW + k];
        dcr[k] = dcr[k] + (dx0_all[2 * k * kTile + r] * cosf(angle) - dx0_all[(2 * k + 1) * kTile + r] * sinf(angle));
        dcr[3 + k] = dcr[3 + k] + dx0_all[(6 + k) * kTile + r] * d.inv_box[k];
      }
    }
    const int av = d.A + d.V;
    for (int idx = threadIdx.x; idx < my_rows(q, n, rows) * av; idx += kConsumers) {
      const int r = q + (idx / av) * n, j = idx % av;
      const float v = dx0_all[(9 + d.S + d.D + j) * kTile + r];
      const size_t bt = (size_t)(b0 + r) * (T - 1) + t;
      if (j < d.A)
        g_actions[bt * d.A + j] = v;
      else
        g_variations[bt * d.V + j - d.A] = v;
    }
    consumer_sync();

    // The teacher-forcing pick: the ground-truth input of step t gets
    // use_gt times the gradient, the previous step's output the rest; the
    // ground-truth frame 0 gets both, plus the loss's own gradient there.
    const float use_gt = t < d.gt_count ? 1.0f : 0.0f;
    for (int idx = threadIdx.x; idx < kTile * SW; idx += kConsumers) {
      const int r = idx / SW, col = idx % SW;
      const float v = col < 6 ? dcur[r * 6 + col] : dx0_all[(3 + col) * kTile + r];
      if (r < rows && r % n == q) {
        const size_t bt = (size_t)(b0 + r) * T + t;
        *state_elem(g_state, col, d, bt) = t == 0 ? v + *state_elem(cot, col, d, bt) : use_gt * v;
      }
      dstate[idx] = (1.0f - use_gt) * v;
    }
  }

  // Index T-1 is never a pick input; the carries' final gradients feed the
  // initial-state gradients.
  for (int idx = threadIdx.x; idx < my_rows(q, n, rows) * SW; idx += kConsumers) {
    const int r = q + (idx / SW) * n;
    *state_elem(g_state, idx % SW, d, (size_t)(b0 + r) * T + T - 1) = 0.0f;
  }
  consumer_sync();
  for (int idx = threadIdx.x; idx < 2 * L * U * kTile; idx += kConsumers) {
    const int part_l = idx / (U * kTile), u = (idx / kTile) % U, r = idx % kTile;  // part_l = part * L + l
    if (r < rows) d_final[((size_t)part_l * B + b0 + r) * F + q * U + u] = dh[idx];
  }
  cluster_sync_all();
}

// out (M, N) = A^T B summed over K rows: A (K, M) row-major with leading
// dimension lda, its first `shift` rows replaced by a_init (M); a null A is
// a column of ones (M = 1). B (K, N) with leading dimension ldb.
struct GradJob {
  const float* a;
  const float* a_init;
  const float* b;
  float* out;
  int lda, ldb, K, M, N, shift, tile_start;
};

struct GradJobs {
  GradJob job[kMaxJobs];
  int count;
};

// (b) One CTA per 32 x 32 output tile of one job; each output summed over
// its K rows in index order.
__global__ void __launch_bounds__(kGradThreads) rollout_wgrad_kernel(GradJobs jobs) {
  __shared__ float as[kGradTile][kGradTile + 1];
  __shared__ float bs[kGradTile][kGradTile + 1];
  int j = 0;
  while (j + 1 < jobs.count && (int)blockIdx.x >= jobs.job[j + 1].tile_start) ++j;
  const GradJob& g = jobs.job[j];
  const int local = blockIdx.x - g.tile_start;
  const int n_tiles = (g.N + kGradTile - 1) / kGradTile;
  const int m0 = (local / n_tiles) * kGradTile, n0 = (local % n_tiles) * kGradTile;
  const int tx = threadIdx.x % kGradTile, ty = threadIdx.x / kGradTile;
  constexpr int kPer = kGradTile * kGradTile / kGradThreads;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < g.K; k0 += kGradTile) {
    for (int idx = threadIdx.x; idx < kGradTile * kGradTile; idx += kGradThreads) {
      const int kk = idx / kGradTile, cc = idx % kGradTile;
      const int k = k0 + kk, m = m0 + cc, n = n0 + cc;
      float va = 0.0f, vb = 0.0f;
      if (k < g.K && m < g.M) {
        if (g.a == nullptr)
          va = 1.0f;
        else if (k < g.shift)
          va = g.a_init[m];
        else
          va = g.a[(size_t)(k - g.shift) * g.lda + m];
      }
      if (k < g.K && n < g.N) vb = g.b[(size_t)k * g.ldb + n];
      as[kk][cc] = va;
      bs[kk][cc] = vb;
    }
    __syncthreads();
    const int kmax = min(kGradTile, g.K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float bv = bs[kk][tx];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(as[kk][ty + i * (kGradThreads / kGradTile)], bv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int m = m0 + ty + i * (kGradThreads / kGradTile), n = n0 + tx;
    if (m < g.M && n < g.N) g.out[(size_t)m * g.N + n] = acc[i];
  }
}

// What the forward reads at row k, column c of CTA q's segment s (its
// image) or column c of its bias block: LSTM columns are u * 4 + gate.
__device__ __forceinline__ float forward_weight(const Params& w, const Dims& d, int s, int q, int k, int c) {
  const int F = d.F, U = d.U, L = d.L;
  if (s < 2 * L) return at(w, 5 * (s / 2) + 1 - s % 2, k, (c % 4) * F + q * U + c / 4);  // wh_l, wx_l
  if (s == 2 * L) return at(w, 5 * L, k, q * U + c);
  const int col = q * d.HU + c;
  return col < d.H ? at(w, 5 * L + 2, k, col) : 0.0f;
}

__device__ __forceinline__ float forward_bias(const Params& w, const Dims& d, int q, int c) {
  const int F = d.F, U = d.U, L = d.L;
  if (c < 4 * U * L) {
    const int l = c / (4 * U), cc = c % (4 * U);
    return at(w, 5 * l + 2, 0, (cc % 4) * F + q * U + cc / 4);
  }
  if (c < 4 * U * L + U) return at(w, 5 * L + 1, 0, q * U + c - 4 * U * L);
  const int col = q * d.HU + c - 4 * U * L - U;
  return col < d.H ? at(w, 5 * L + 3, 0, col) : 0.0f;
}

// What the backward recurrence reads at row k, column c of CTA q's segment
// s: whead's and wb's rows of its units, then per layer, top down, over the
// 4F gate columns, wh's rows of its units beside wx's (layer 0: its XU input
// rows, zero past in0).
__device__ __forceinline__ float backward_weight(const Params& w, const Dims& d, int s, int q, int k, int c) {
  const int U = d.U, L = d.L;
  if (s == 0) return at(w, 5 * L + 2, q * U + c, k);
  if (s == 1) return at(w, 5 * L, q * U + c, k);
  const int l = L - 1 - (s - 2);
  if (c < U) return at(w, 5 * l + 1, q * U + c, k);
  const int row = l > 0 ? q * U + c - U : q * d.XU + c - U;
  return l > 0 || row < d.in0 ? at(w, 5 * l, row, k) : 0.0f;
}

// The per-call weight image (n, per-CTA floats), and for the forward the
// biases (n, L 4U + U + HU) after it: a gather. Block (x, q, s) writes
// elements [256 x, 256 x + 256) of CTA q's segment s (s = count: its biases).
__global__ void __launch_bounds__(256)
    rollout_image_kernel(const __grid_constant__ Params w, const __grid_constant__ Dims d,
                         const __grid_constant__ Segments seg, int fwd, float* __restrict__ image,
                         float* __restrict__ bias) {
  const int q = blockIdx.y, s = blockIdx.z, i = blockIdx.x * 256 + threadIdx.x;
  if (s == seg.count) {
    const int nb = d.L * 4 * d.U + d.U + d.HU;
    if (i < nb) bias[q * nb + i] = forward_bias(w, d, q, i);
    return;
  }
  if (i >= seg.K[s] * seg.W[s]) return;
  const int k = i / seg.W[s], c = i % seg.W[s];
  image[(size_t)q * seg.per_cta + seg.offset[s] + i] =
      fwd ? forward_weight(w, d, s, q, k, c) : backward_weight(w, d, s, q, k, c);
}

cudaError_t launch_image(const Params& w, const Dims& d, int fwd, float* image, float* bias, cudaStream_t stream) {
  const Segments seg = fwd ? forward_segments(d) : backward_segments(d);
  int most = fwd ? d.L * 4 * d.U + d.U + d.HU : 0;
  for (int s = 0; s < seg.count; ++s) most = imax(most, seg.K[s] * seg.W[s]);
  rollout_image_kernel<<<dim3((most + 255) / 256, d.n, seg.count + fwd), 256, 0, stream>>>(w, d, seg, fwd, image,
                                                                                          bias);
  return cudaGetLastError();
}

Dims make_dims(const int* ints, const float* floats) {
  // ints: batch, T, F, L, S, D, A, V, gt_count, axis, force_rot, force_axis,
  // n, U, HU, XU, stages; floats: axis_value, 1 / box (3).
  Dims d;
  d.batch = ints[0];
  d.T = ints[1];
  d.F = ints[2];
  d.L = ints[3];
  d.S = ints[4];
  d.D = ints[5];
  d.A = ints[6];
  d.V = ints[7];
  d.gt_count = ints[8];
  d.axis = ints[9];
  d.force_rot = ints[10];
  d.force_axis = ints[11];
  d.n = ints[12];
  d.U = ints[13];
  d.HU = ints[14];
  d.XU = ints[15];
  d.stages = ints[16];
  d.in0 = 9 + d.S + d.D + d.A + d.V;
  d.H = 9 + d.S + d.D;
  d.SW = 6 + d.S + d.D;
  d.axis_value = floats[0];
  for (int k = 0; k < 3; ++k) d.inv_box[k] = floats[1 + k];
  return d;
}

Residuals make_residuals(void* const* p, int L) {
  Residuals r = {};
  if (p == nullptr) return r;
  for (int k = 0; k < 4; ++k) r.cur[k] = (float*)p[k];
  r.x0 = (float*)p[4];
  r.y = (float*)p[5];
  r.head = (float*)p[6];
  for (int l = 0; l < L; ++l) {
    r.gates[l] = (float*)p[7 + 3 * l];
    r.c[l] = (float*)p[8 + 3 * l];
    r.h[l] = (float*)p[9 + 3 * l];
  }
  return r;
}

Params make_params(const void* const* params, const int* strides, int L) {
  Params w = {};
  for (int i = 0; i < 5 * L + 4; ++i) {
    w.p[i] = (const float*)params[i];
    w.rs[i] = strides[2 * i];
    w.cs[i] = strides[2 * i + 1];
  }
  return w;
}

// Times between consecutive events (ms), after waiting for the last.
struct Timer {
  cudaEvent_t events[4];
  int count = 0;
  float* ms;
  cudaStream_t stream;
  Timer(float* ms_, cudaStream_t s) : ms(ms_), stream(s) {}
  void mark() {
    if (ms == nullptr) return;
    cudaEventCreate(&events[count]);
    cudaEventRecord(events[count++], stream);
  }
  cudaError_t finish() {
    if (ms == nullptr) return cudaSuccess;
    cudaError_t err = cudaEventSynchronize(events[count - 1]);
    for (int i = 0; i + 1 < count; ++i) cudaEventElapsedTime(&ms[i], events[i], events[i + 1]);
    return err;
  }
  ~Timer() {
    for (int i = 0; i < count; ++i) cudaEventDestroy(events[i]);
  }
};

// The kernel's attributes for `smem` bytes and clusters of n, then the
// launch config of `tiles` clusters.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int tiles, int n, int smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  static int set_smem[64] = {};  // per device, what was last set
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || set_smem[device] != smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (device < 64) set_smem[device] = smem;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(tiles * n);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Each launcher runs on `stream` and returns the CUDA error code (0 on
// success). The Python wrapper (ops/fused_rollout.py) checks shapes and
// limits, chooses the cluster and the ring and allocates every buffer. All
// tensors f32, contiguous: inputs (B, T, .) and (B, T-1, .), outputs
// (B, T, .).
//
// ints: batch, T, F, L, S, D, A, V, gt_count, axis, force_rot, force_axis,
// n, U, HU, XU, stages. floats: axis_value, 1 / box (3). params, strides:
// the 5 L + 4 parameters and their (row, column) strides (struct Params;
// the vectors' column strides must be 1). image: room for the weight image the launcher
// gathers first (and for the forward, bias: room for its biases).
// residuals: null, or 7 + 3 L pointers in the order of struct Residuals.
// With `ms`, records CUDA events around the launches, waits for them and
// writes their times there (forward: gather, rollout; backward: gather,
// recurrence, weight gradients).
extern "C" int fused_rollout_fwd_launch(const int* ints, const float* floats, const void* const* params,
                                        const int* strides, void* image, void* bias, const void* rot, const void* trans,
                                        const void* style, const void* deform, const void* actions,
                                        const void* variations, void* out_rot, void* out_trans, void* out_style,
                                        void* out_deform, void* const* residuals, int collect, float* ms,
                                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d = make_dims(ints, floats);
  const Params p = make_params(params, strides, d.L);
  const Residuals res = make_residuals(collect ? residuals : nullptr, d.L);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(rollout_fwd_kernel, (d.batch + kTile - 1) / kTile, d.n, fwd_smem(d).bytes, s,
                                   &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  Timer timer(ms, s);
  timer.mark();
  err = launch_image(p, d, 1, (float*)image, (float*)bias, s);
  if (err != cudaSuccess) return (int)err;
  timer.mark();
  const State4<const float*> gt = {(const float*)rot, (const float*)trans, (const float*)style, (const float*)deform};
  const State4<float*> outs = {(float*)out_rot, (float*)out_trans, (float*)out_style, (float*)out_deform};
  err = cudaLaunchKernelEx(&cfg, rollout_fwd_kernel, (const float*)image, (const float*)bias, p,
                           res, d, forward_segments(d), collect, gt, (const float*)actions, (const float*)variations,
                           outs);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  timer.mark();
  return (int)timer.finish();
}

// ints, floats, params, image: as the forward's (the backward's image, no
// biases). residuals: as the forward's. grads: outputs in the parameters'
// order and shapes. Scratch: dz (L, T-1, B, 4F), dy (T-1, B, F), dhead
// (T-1, B, H), d_final (2, L, B, F).
extern "C" int fused_rollout_bwd_launch(const int* ints, const float* floats, const void* const* params,
                                        const int* strides, void* image, void* const* residuals, const void* cot_rot,
                                        const void* cot_trans, const void* cot_style, const void* cot_deform,
                                        void* const* grads, void* g_rot, void* g_trans, void* g_style,
                                        void* g_deform, void* g_actions, void* g_variations, void* dz, void* dy,
                                        void* dhead, void* d_final, float* ms, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Dims d = make_dims(ints, floats);
  const Params p = make_params(params, strides, d.L);
  const Residuals res = make_residuals(residuals, d.L);
  const int batch = d.batch, F = d.F, L = d.L;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(rollout_bwd_recurrence_kernel, (batch + kTile - 1) / kTile, d.n,
                                   bwd_smem(d).bytes, s, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  Timer timer(ms, s);
  timer.mark();
  err = launch_image(p, d, 0, (float*)image, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  timer.mark();
  const State4<const float*> cot = {(const float*)cot_rot, (const float*)cot_trans, (const float*)cot_style,
                                    (const float*)cot_deform};
  const State4<float*> g_state = {(float*)g_rot, (float*)g_trans, (float*)g_style, (float*)g_deform};
  err = cudaLaunchKernelEx(&cfg, rollout_bwd_recurrence_kernel, (const float*)image, p, res, d, backward_segments(d),
                           cot, g_state,
                           (float*)g_actions, (float*)g_variations, (float*)dz, (float*)dy, (float*)dhead,
                           (float*)d_final);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  timer.mark();

  const int rows = (d.T - 1) * batch;
  const size_t dz_layer = (size_t)rows * 4 * F;
  GradJobs jobs = {};
  auto add = [&](const float* a, const float* a_init, int shift, int lda, const float* b, int ldb, int K, int M,
                 int N, void* out) {
    GradJob& g = jobs.job[jobs.count++];
    g.a = a;
    g.a_init = a_init;
    g.shift = shift;
    g.lda = lda;
    g.b = b;
    g.ldb = ldb;
    g.K = K;
    g.M = M;
    g.N = N;
    g.out = (float*)out;
  };
  for (int l = 0; l < L; ++l) {
    const float* dz_l = (const float*)dz + l * dz_layer;
    const int in_l = l == 0 ? d.in0 : F;
    add(l == 0 ? res.x0 : res.h[l - 1], nullptr, 0, in_l, dz_l, 4 * F, rows, in_l, 4 * F, grads[5 * l]);
    add(res.h[l], p.p[5 * l + 3], batch, F, dz_l, 4 * F, rows, F, 4 * F, grads[5 * l + 1]);
    add(nullptr, nullptr, 0, 0, dz_l, 4 * F, rows, 1, 4 * F, grads[5 * l + 2]);
    add(nullptr, nullptr, 0, 0, (const float*)d_final + (size_t)l * batch * F, F, batch, 1, F, grads[5 * l + 3]);
    add(nullptr, nullptr, 0, 0, (const float*)d_final + (size_t)(L + l) * batch * F, F, batch, 1, F,
        grads[5 * l + 4]);
  }
  add(res.h[L - 1], nullptr, 0, F, (const float*)dy, F, rows, F, F, grads[5 * L]);
  add(nullptr, nullptr, 0, 0, (const float*)dy, F, rows, 1, F, grads[5 * L + 1]);
  add(res.y, nullptr, 0, F, (const float*)dhead, d.H, rows, F, d.H, grads[5 * L + 2]);
  add(nullptr, nullptr, 0, 0, (const float*)dhead, d.H, rows, 1, d.H, grads[5 * L + 3]);
  int total = 0;
  for (int j = 0; j < jobs.count; ++j) {
    GradJob& g = jobs.job[j];
    g.tile_start = total;
    total += ((g.M + kGradTile - 1) / kGradTile) * ((g.N + kGradTile - 1) / kGradTile);
  }
  rollout_wgrad_kernel<<<total, kGradThreads, 0, s>>>(jobs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  timer.mark();
  return (int)timer.finish();
}

// The weight image alone (fwd 1: the forward's and its biases; 0: the
// backward's), as the launchers gather it; for holding the gather against
// its plain version (ops/fused_rollout.py::rollout_fwd_image / _bwd_image).
extern "C" int fused_rollout_image_launch(const int* ints, const float* floats, const void* const* params,
                                          const int* strides, int fwd, void* image, void* bias, void* stream) {
  const Dims d = make_dims(ints, floats);
  return (int)launch_image(make_params(params, strides, d.L), d, fwd, (float*)image, (float*)bias,
                           (cudaStream_t)stream);
}

// How many clusters of n CTAs with `smem` bytes each the card can hold at
// once (cudaOccupancyMaxActiveClusters) for the forward (fwd 1) or the
// backward recurrence; a negative CUDA error code on failure.
extern "C" int fused_rollout_max_clusters(int fwd, int n, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err;
  if (fwd) {
    err = cluster_config(rollout_fwd_kernel, 1, n, smem, 0, &cfg, &attr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, rollout_fwd_kernel, &cfg);
  } else {
    err = cluster_config(rollout_bwd_recurrence_kernel, 1, n, smem, 0, &cfg, &attr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, rollout_bwd_recurrence_kernel, &cfg);
  }
  return err == cudaSuccess ? clusters : -(int)err;
}
