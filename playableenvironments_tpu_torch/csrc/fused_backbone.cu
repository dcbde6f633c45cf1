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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTile = 128;        // points per tile: two consumer warpgroups of 64 rows
constexpr int kPe = 64;           // encoding columns, zero-padded
constexpr int kBlock = 64 * 64;   // elements of one swizzled 64 x 64 block (8 KB)
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread issues)
constexpr int kMaxLayers = 8;     // the backward's ReLU-mask bits in shared memory
constexpr int kSlotBytes = 64 * 256 * 2;   // ring slot, sized for W = 256
constexpr int kFwdStages = 4, kBwdStages = 3, kDwStages = 4;
constexpr int kActBytes = 4 * kTile * 128;  // bf16 activations, 4 blocks of 128 rows
constexpr int kEncBytes = kTile * 128;      // bf16 encodings, 1 block of 128 rows
constexpr int kMaskBytes = kMaxLayers * 256 * 4 * 4;
constexpr int kStagingBytes = 8 * 256 * 4;  // per-warp column sums
constexpr int kDwStageBytes = 2 * 8192 + kSlotBytes;
constexpr size_t kFwdSmem = 1024 + (size_t)kFwdStages * kSlotBytes + kActBytes + kEncBytes + 256;
constexpr size_t kBwdSmem =
    1024 + (size_t)kBwdStages * kSlotBytes + kActBytes + kEncBytes + kMaskBytes + kStagingBytes + 256;
constexpr size_t kDwSmem = 1024 + (size_t)kDwStages * kDwStageBytes + 256;

// ---- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed. Traps (a launch
// error) instead of hanging if a pipeline fault leaves it waiting 2 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 1023u) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 2000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }
// Waits until this thread's bulk stores have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// Makes this thread's shared-memory writes visible to wgmma and bulk copies.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor in 128-byte swizzle mode: start address,
// leading and stride byte offsets (PTX ISA, wgmma matrix descriptor). K-major
// operands: stride = 1,024 bytes between groups of 8 rows, the leading offset
// unused. MN-major: leading = bytes between 64-element column blocks, stride
// = 1,024 bytes between groups of 8 k rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}

// The descriptor of a base address, opaque to the compiler: the per-k
// descriptors (base + byte offset / 16) are then formed where they are used
// instead of being hoisted out of every loop and kept live in registers.
__device__ __forceinline__ uint64_t sw128_base(uint32_t addr, uint32_t lead, uint32_t stride) {
  uint64_t d = sw128_desc(addr, lead, stride);
  asm volatile("mov.b64 %0, %0;" : "+l"(d));
  return d;
}

// m64nNk16 bf16 x bf16 -> f32, A and B from shared memory, accumulator
// d[N / 2] in wgmma's fragment layout: thread t of the warpgroup holds, for
// column group j < N / 8 and e < 4, row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
// and column 8 j + 2 (t % 4) + e % 2 in d[4 j + e].
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int N, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma width");
  if constexpr (N == 64) wgmma_n64<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_n128<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 192) wgmma_n192<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 256) wgmma_n256<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
}

// ---- the backbone's structure ------------------------------------------------

__device__ __forceinline__ int layer_slots(int i, int nb, int skip) { return i == 0 ? 1 : nb + (i == skip); }

__device__ __forceinline__ int first_slot(int i, int nb, int skip) {
  int s = 0;
  for (int j = 0; j < i; ++j) s += layer_slots(j, nb, skip);
  return s;
}

// Byte offset of (row, col) in a tile of 64-column swizzled blocks of `rows`
// rows each (the activation tile: 128 rows, column block c at c * 16 KB).
__device__ __forceinline__ uint32_t tile_offset(int rows, int row, int col) {
  return (uint32_t)(((col >> 6) * rows + row) * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2);
}

// The ring of weight slots: `full` completes when a slot has landed, `empty`
// when all 8 consumer warps are done with it.
struct Ring {
  uint32_t slots, full, empty;
  int stage, phase;
};

template <int kStages>
__device__ __forceinline__ void ring_advance(Ring& r) {
  if (++r.stage == kStages) {
    r.stage = 0;
    r.phase ^= 1;
  }
}

// Producer: streams slots [first, first + count) of the weight image.
template <int kStages>
__device__ void produce_slots(Ring& r, const unsigned char* image, uint32_t slot_bytes, int first, int count) {
  for (int s = first; s < first + count; ++s) {
    mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1);
    mbar_expect_tx(r.full + 8 * r.stage, slot_bytes);
    bulk_load(r.slots + r.stage * kSlotBytes, image + (size_t)s * slot_bytes, slot_bytes, r.full + 8 * r.stage);
    ring_advance<kStages>(r);
  }
}

// Consumer side of one slot: wait for it, issue its products (`issue` takes
// the slot's shared address), keep one group in flight, release the slot
// before (prev) once its products are done.
template <int kStages, typename Issue>
__device__ __forceinline__ void consume_slot(Ring& r, int& prev, int lane, Issue issue) {
  mbar_wait(r.full + 8 * r.stage, r.phase);
  wgmma_fence();
  issue(r.slots + r.stage * kSlotBytes);
  wgmma_commit();
  wgmma_wait<1>();
  if (prev >= 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
  prev = r.stage;
  ring_advance<kStages>(r);
}

__device__ __forceinline__ void release_last(Ring& r, int prev, int lane) {
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(r.empty + 8 * prev);
}

// The warpgroup's encodings (f32 in the forward, bf16 in the backward),
// rounded to bf16 and zero-padded to kPe columns, into its 64 rows of the
// encoding tile.
template <typename T>
__device__ __forceinline__ void load_encoding(const T* __restrict__ encoded, unsigned char* enc, int wg, int row0,
                                              int n_points, int pe, int t) {
  for (int idx = t; idx < 64 * kPe; idx += 128) {
    const int r = idx / kPe, col = idx % kPe;
    const int point = row0 + 64 * wg + r;
    bf16 v = __float2bfloat16(0.0f);
    if (point < n_points && col < pe) v = __float2bfloat16(static_cast<float>(encoded[(size_t)point * pe + col]));
    *reinterpret_cast<bf16*>(enc + tile_offset(kTile, 64 * wg + r, col)) = v;
  }
}

// The warpgroup's rows of the activation tile <- bf16(v).
template <int W>
__device__ __forceinline__ void store_tile(unsigned char* act, const float* v, int wg, int t) {
  const int q = t & 3, r0 = 64 * wg + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(kTile, r0 + 8 * h, 8 * j + 2 * q)) =
          __floats2bfloat162_rn(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
}

// acc = relu(acc + b).
template <int W>
__device__ __forceinline__ void bias_relu(float* acc, const float* __restrict__ b, int t) {
  const int q = t & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * q));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = fmaxf(acc[4 * j + e] + ((e & 1) ? bb.y : bb.x), 0.0f);
  }
}

// One forward layer for the warpgroup's 64 rows: acc = A_i @ W_i over the
// layer's slots, A the activation tile (h slots) or the encoding tile (the
// encoding slot), both K-major; the slot MN-major.
template <int W, int kStages>
__device__ __forceinline__ void forward_layer(float* acc, Ring& r, int i, int skip, uint32_t act, uint32_t enc,
                                              int wg, int lane) {
  constexpr int nb = W / 64;
  const int slots = layer_slots(i, nb, skip);
  int prev = -1;
  for (int j = 0; j < slots; ++j) {
    const bool enc_slot = i == 0 || j == nb;
    const uint32_t a = enc_slot ? enc + wg * 64 * 128 : act + (j * kTile + wg * 64) * 128;
    consume_slot<kStages>(r, prev, lane, [&](uint32_t slot) {
      const uint64_t da = sw128_base(a, 16, 1024), db = sw128_base(slot, 8192, 1024);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma<W, 0, 1>(acc, da + 2 * k, db + 128 * k, (j > 0 || k > 0) ? 1 : 0);
    });
  }
  release_last(r, prev, lane);
  fence_regs<W / 2>(acc);
}

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

struct Smem {
  unsigned char* base;  // generic pointer, 1,024-byte aligned
  uint32_t addr;        // its shared-memory address
};

__device__ __forceinline__ Smem aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  const uint32_t aligned = (a + 1023u) & ~1023u;
  return {raw + (aligned - a), aligned};
}

__device__ __forceinline__ void init_ring(Ring& r, uint32_t slots, uint32_t bars, int stages, int consumer_warps) {
  r.slots = slots;
  r.full = bars;
  r.empty = bars + 8 * stages;
  r.stage = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
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
