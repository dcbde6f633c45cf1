// Shared by the NeRF MLP kernels for Hopper (sm_90a): B1's eval AdaIN-NeRF
// MLP (fused_nerf.cu) and B2/B3's trainable backbone (fused_backbone.cu,
// and fused_backbone_f32.cu for f32 operands, which uses the PTX wrappers,
// the ring and the backward's fixed-order column sums).
//
// PTX wrappers (mbarriers, bulk asynchronous copies, cluster addressing,
// setmaxnreg, wgmma with its fences and 128-byte-swizzle descriptors) and
// the pieces both forward kernels are made of: a ring of weight slots in
// shared memory that one producer thread fills by bulk copies and two
// consumer warpgroups of 64 rows read as wgmma's B operand; the 128-point
// activation tile in wgmma's swizzled K-major layout, with its encoding
// columns beside it; and the backbone layer `forward_layer`, whose
// accumulators end in registers. The weight image they stream is described
// in fused_backbone.cu (the backbone) and fused_nerf.cu (B1's heads after
// it).
//
// The ring runs on one CTA, or on a 2-CTA cluster whose CTAs consume the
// same slot sequence in lockstep (kCtas 2): each CTA's producer copies half
// of every slot into both CTAs' rings with one multicast bulk copy, and a
// slot is free again only when the consumer warps of both CTAs have
// released it.

#pragma once

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
constexpr int kSlotBytes = 64 * 256 * 2;   // ring slot, sized for W = 256
constexpr int kActBytes = 4 * kTile * 128;  // bf16 activations, 4 blocks of 128 rows
constexpr int kEncBytes = kTile * 128;      // bf16 encodings, 1 block of 128 rows

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

// The same copy, half of it by each CTA of a 2-CTA cluster: `bytes` from
// `src` land at `dst` in both CTAs' shared memory, each completing on its
// own mbarrier at `bar` (CTA-relative addresses, the same in both).
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  const uint16_t both = 0x3;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(both)
      : "memory");
}

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

// Arrives on an mbarrier of another CTA of the cluster with the default
// (CTA-scope) release: enough for a consumer's release of a ring slot,
// whose reads (wgmma, completed) the other CTA's bulk copy must not
// overtake. A release at cluster scope here, once a slot per consumer warp,
// made B1 slower than with no cluster at all (scripts/ablate_adain_nerf.py).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote_bar) : "memory");
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
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
// when all consumer warps are done with it (8; 16 on a 2-CTA cluster, whose
// CTAs share every slot).
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

// Producer: `bytes` (at most kSlotBytes) from `src` into the next slot once
// every consumer has released it. On a 2-CTA cluster (kCtas 2) both CTAs'
// producers run this for the same slot: each copies half of it into both
// CTAs, and each CTA's `full` expects the whole slot.
template <int kStages, int kCtas = 1>
__device__ __forceinline__ void produce_slot(Ring& r, const unsigned char* src, uint32_t bytes) {
  mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1);
  mbar_expect_tx(r.full + 8 * r.stage, bytes);
  const uint32_t dst = r.slots + r.stage * kSlotBytes;
  if constexpr (kCtas == 1) {
    bulk_load(dst, src, bytes, r.full + 8 * r.stage);
  } else {
    const uint32_t half = bytes / 2, off = cluster_rank() * half;
    bulk_load_multicast(dst + off, src + off, half, r.full + 8 * r.stage);
  }
  ring_advance<kStages>(r);
}

// Producer: streams slots [first, first + count) of the weight image.
template <int kStages>
__device__ void produce_slots(Ring& r, const unsigned char* image, uint32_t slot_bytes, int first, int count) {
  for (int s = first; s < first + count; ++s) produce_slot<kStages>(r, image + (size_t)s * slot_bytes, slot_bytes);
}

// A consumer warp's release of slot `stage`: in its own CTA, and on a 2-CTA
// cluster in the other CTA too, whose producer also writes the slot.
template <int kCtas>
__device__ __forceinline__ void release_slot(const Ring& r, int stage) {
  mbar_arrive(r.empty + 8 * stage);
  if constexpr (kCtas > 1) mbar_arrive_remote(mapa(r.empty + 8 * stage, cluster_rank() ^ 1));
}

// Consumer side of one slot: wait for it, issue its products (`issue` takes
// the slot's shared address), keep one group in flight, release the slot
// before (prev) once its products are done.
template <int kStages, int kCtas = 1, typename Issue>
__device__ __forceinline__ void consume_slot(Ring& r, int& prev, int lane, Issue issue) {
  mbar_wait(r.full + 8 * r.stage, r.phase);
  wgmma_fence();
  issue(r.slots + r.stage * kSlotBytes);
  wgmma_commit();
  wgmma_wait<1>();
  if (prev >= 0 && lane == 0) release_slot<kCtas>(r, prev);
  prev = r.stage;
  ring_advance<kStages>(r);
}

template <int kCtas = 1>
__device__ __forceinline__ void release_last(Ring& r, int prev, int lane) {
  wgmma_wait<0>();
  if (lane == 0) release_slot<kCtas>(r, prev);
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

// The warpgroup's rows of the activation tile, columns [col0, col0 + W),
// <- bf16(v).
template <int W>
__device__ __forceinline__ void store_tile(unsigned char* act, const float* v, int wg, int t, int col0 = 0) {
  const int q = t & 3, r0 = 64 * wg + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(act + tile_offset(kTile, r0 + 8 * h, col0 + 8 * j + 2 * q)) =
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
template <int W, int kStages, int kCtas = 1>
__device__ __forceinline__ void forward_layer(float* acc, Ring& r, int i, int skip, uint32_t act, uint32_t enc,
                                              int wg, int lane) {
  constexpr int nb = W / 64;
  const int slots = layer_slots(i, nb, skip);
  int prev = -1;
  for (int j = 0; j < slots; ++j) {
    const bool enc_slot = i == 0 || j == nb;
    const uint32_t a = enc_slot ? enc + wg * 64 * 128 : act + (j * kTile + wg * 64) * 128;
    consume_slot<kStages, kCtas>(r, prev, lane, [&](uint32_t slot) {
      const uint64_t da = sw128_base(a, 16, 1024), db = sw128_base(slot, 8192, 1024);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma<W, 0, 1>(acc, da + 2 * k, db + 128 * k, (j > 0 || k > 0) ? 1 : 0);
    });
  }
  release_last<kCtas>(r, prev, lane);
  fence_regs<W / 2>(acc);
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

// ---- the backward kernels' column sums ------------------------------------------

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

}  // namespace
