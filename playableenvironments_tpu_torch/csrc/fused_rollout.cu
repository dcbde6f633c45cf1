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
// Bound: at the tennis phase-3 shape (16 rows, T 9, F 256, 2 layers, 117
// inputs) a launch is 255.6 MFLOP forward, about twice that backward, and
// ~6-10 MB of weights, residuals and I/O: a few microseconds at the card's
// f32 peak or memory rate. But the T-1 steps are serial and each step is
// ~10 dependent products over 16 rows, so what bounds these kernels is the
// latency of that chain on one SM per 16 rows, not operations or bytes.
// This first version is simple and exact: products and activations in f32
// on the CUDA cores, as the reference computes them (`_matmul` with f32
// operands), one thread per output column and group of rows, sums in a
// fixed order. Making the chain short (clusters that split the columns,
// tensor cores) is later work.
//
// Forward (rollout_fwd_kernel): one CTA of 512 threads per tile of 16
// batch rows, one launch per object. The CTA keeps in shared memory for all
// steps the carries c and h of every layer, the current state, the step's
// input row block and its gate pre-activations (145 KB at F 256 and 2
// layers); the y and head blocks reuse the gate block. The weights (4.0 MB
// per player at the tennis sizes) are read from L2 at every step, where
// they stay. Residuals go to global memory in the JAX layout (T-1, B, .),
// only when asked.
//
// Backward, two kernels:
// (a) rollout_bwd_recurrence_kernel, one CTA per 16-row tile: the serial
//     reverse chain (d_c and d_h carries, the teacher-forcing pick, the head
//     and backbone backward, d_x = dz wx^T and d_h = dz wh^T with the
//     transposed weights). It writes each layer's dz (T-1, B, 4F), d_y
//     (T-1, B, F) and d_head (T-1, B, H) to scratch, the state, action and
//     variation gradients to their outputs, and the tile's final d_h and
//     d_c (the initial-carry gradients before the batch sum).
// (b) rollout_wgrad_kernel: every parameter gradient over all (T-1) B rows
//     at once, g_wx = X^T dZ, g_wh = Hprev^T dZ (Hprev's first B rows are
//     h_init), g_wb = H_top^T dY, g_whead = Y^T dHead, and the bias and
//     initial-carry gradients as column sums (a column of ones as X). Many
//     CTAs, each owning a 32 x 32 output tile and summing its rows in index
//     order: no atomics, so the gradients are bit-identical run to run. The
//     TPU kernel instead +=s ~4 MB of gradients into its outputs at every
//     step of a sequential grid.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;      // batch rows per CTA
constexpr int kThreads = 512;  // recurrence kernels
constexpr int kMaxLayers = 4;
constexpr int kGradTile = 32;  // weight-gradient output tile edge
constexpr int kGradThreads = 256;
constexpr int kMaxJobs = 5 * kMaxLayers + 4;

struct Dims {
  int batch, T, F, L, S, D, A, V, in0, H, SW, gt_count, axis, force_rot, force_axis;
  float axis_value, inv_box[3];
};

struct Weights {  // forward layout: W (in, out) row-major
  const float* wx[kMaxLayers];
  const float* wh[kMaxLayers];
  const float* bh[kMaxLayers];
  const float* h_init[kMaxLayers];
  const float* c_init[kMaxLayers];
  const float* wb;
  const float* bb;
  const float* whead;
  const float* bhead;
};

struct WeightsT {  // backward layout: W^T (out, in) row-major
  const float* wx_t[kMaxLayers];
  const float* wh_t[kMaxLayers];
  const float* c_init[kMaxLayers];
  const float* wb_t;
  const float* whead_t;
};

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

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// out[r][c] = bias[c] + sum_k a0[r][k] w0[k][c] + sum_k a1[r][k] w1[k][c]
// for the kTile rows of the tile and c < ncols. a0 and a1 lie in shared
// memory (row strides lda0, lda1), w0 (k0, ncols) and w1 (k1, ncols) in
// global memory, row-major. One thread per (column, group of kRpt rows);
// each sum runs over k in order.
template <int kRpt>
__device__ __forceinline__ void rows_matmul_t(float* out, int ldo, const float* a0, int lda0, int k0,
                                              const float* __restrict__ w0, const float* a1, int lda1,
                                              int k1, const float* __restrict__ w1, int ncols,
                                              const float* __restrict__ bias) {
  constexpr int kGroups = kTile / kRpt;
  for (int item = threadIdx.x; item < ncols * kGroups; item += blockDim.x) {
    const int c = item % ncols;
    const int r0 = (item / ncols) * kRpt;
    float acc[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < k0; ++k) {
      const float w = __ldg(w0 + (size_t)k * ncols + c);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(a0[(r0 + i) * lda0 + k], w, acc[i]);
    }
#pragma unroll 4
    for (int k = 0; k < k1; ++k) {
      const float w = __ldg(w1 + (size_t)k * ncols + c);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(a1[(r0 + i) * lda1 + k], w, acc[i]);
    }
    const float b = bias != nullptr ? __ldg(bias + c) : 0.0f;
#pragma unroll
    for (int i = 0; i < kRpt; ++i) out[(r0 + i) * ldo + c] = acc[i] + b;
  }
}

__device__ void rows_matmul(float* out, int ldo, const float* a0, int lda0, int k0, const float* w0,
                            const float* a1, int lda1, int k1, const float* w1, int ncols,
                            const float* bias) {
  if (ncols >= (int)blockDim.x)
    rows_matmul_t<16>(out, ldo, a0, lda0, k0, w0, a1, lda1, k1, w1, ncols, bias);
  else if (2 * ncols >= (int)blockDim.x)
    rows_matmul_t<8>(out, ldo, a0, lda0, k0, w0, a1, lda1, k1, w1, ncols, bias);
  else
    rows_matmul_t<4>(out, ldo, a0, lda0, k0, w0, a1, lda1, k1, w1, ncols, bias);
}

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
__device__ __forceinline__ float rotate_dtheta(int axis, float c, float s, const float* v,
                                               const float* d) {
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

// state row r <- the ground truth at step t (rows past the batch: zeros).
__device__ void load_ground_truth(float* state, const float* __restrict__ rot,
                                  const float* __restrict__ trans, const float* __restrict__ style,
                                  const float* __restrict__ deform, int b0, int rows, int t,
                                  const Dims& d) {
  for (int idx = threadIdx.x; idx < kTile * d.SW; idx += blockDim.x) {
    const int r = idx / d.SW, col = idx % d.SW;
    float v = 0.0f;
    if (r < rows) {
      const size_t bt = (size_t)(b0 + r) * d.T + t;
      if (col < 3)
        v = rot[bt * 3 + col];
      else if (col < 6)
        v = trans[bt * 3 + col - 3];
      else if (col < 6 + d.S)
        v = style[bt * d.S + col - 6];
      else
        v = deform[bt * d.D + col - 6 - d.S];
    }
    state[idx] = v;
  }
}

__device__ void store_state(const float* state, float* __restrict__ rot, float* __restrict__ trans,
                            float* __restrict__ style, float* __restrict__ deform, int b0, int rows,
                            int t, const Dims& d) {
  for (int idx = threadIdx.x; idx < rows * d.SW; idx += blockDim.x) {
    const int r = idx / d.SW, col = idx % d.SW;
    const size_t bt = (size_t)(b0 + r) * d.T + t;
    const float v = state[idx];
    if (col < 3)
      rot[bt * 3 + col] = v;
    else if (col < 6)
      trans[bt * 3 + col - 3] = v;
    else if (col < 6 + d.S)
      style[bt * d.S + col - 6] = v;
    else
      deform[bt * d.D + col - 6 - d.S] = v;
  }
}

// rows x width block of shared memory (row stride ld) -> residual (T-1, B, width) at step t.
__device__ void store_rows(float* __restrict__ dst, const float* src, int ld, int width, int t, int b0,
                           int rows, int batch) {
  float* base = dst + ((size_t)t * batch + b0) * width;
  for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x)
    base[idx] = src[(idx / width) * ld + idx % width];
}

__global__ void __launch_bounds__(kThreads)
    rollout_fwd_kernel(Weights w, Residuals res, Dims d, int collect, const float* __restrict__ rot,
                       const float* __restrict__ trans, const float* __restrict__ style,
                       const float* __restrict__ deform, const float* __restrict__ actions,
                       const float* __restrict__ variations, float* __restrict__ out_rot,
                       float* __restrict__ out_trans, float* __restrict__ out_style,
                       float* __restrict__ out_deform) {
  extern __shared__ float smem[];
  const int F = d.F, L = d.L, SW = d.SW, in0 = d.in0, H = d.H, B = d.batch;
  const int zw = max(4 * F, F + H);
  float* state = smem;              // kTile x SW: rot 3 | trans 3 | style S | deform D
  float* x0 = state + kTile * SW;   // kTile x in0
  float* hs = x0 + kTile * in0;     // L x kTile x F
  float* cs = hs + L * kTile * F;   // L x kTile x F
  float* z = cs + L * kTile * F;    // kTile x zw: gate pre-activations, then y | head
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, B - b0);

  for (int idx = threadIdx.x; idx < L * kTile * F; idx += blockDim.x) {
    const int l = idx / (kTile * F), j = idx % F;
    cs[idx] = w.c_init[l][j];
    hs[idx] = w.h_init[l][j];
  }
  load_ground_truth(state, rot, trans, style, deform, b0, rows, 0, d);
  __syncthreads();
  store_state(state, out_rot, out_trans, out_style, out_deform, b0, rows, 0, d);

  for (int t = 0; t < d.T - 1; ++t) {
    __syncthreads();
    if (t < d.gt_count) load_ground_truth(state, rot, trans, style, deform, b0, rows, t, d);
    __syncthreads();
    if (collect) {
      store_rows(res.cur[0], state, SW, 3, t, b0, rows, B);
      store_rows(res.cur[1], state + 3, SW, 3, t, b0, rows, B);
      store_rows(res.cur[2], state + 6, SW, d.S, t, b0, rows, B);
      store_rows(res.cur[3], state + 6 + d.S, SW, d.D, t, b0, rows, B);
    }
    // The step's input: sin/cos pairs, translations / box, style,
    // deformation, action, variation.
    for (int idx = threadIdx.x; idx < kTile * in0; idx += blockDim.x) {
      const int r = idx / in0, col = idx % in0;
      const float* s = state + r * SW;
      float v;
      if (col < 6)
        v = (col & 1) ? cosf(s[col >> 1]) : sinf(s[col >> 1]);
      else if (col < 9)
        v = s[col - 3] * d.inv_box[col - 6];
      else if (col < 9 + d.S + d.D)
        v = s[col - 3];
      else if (r >= rows)
        v = 0.0f;
      else if (col < 9 + d.S + d.D + d.A)
        v = actions[((size_t)(b0 + r) * (d.T - 1) + t) * d.A + col - 9 - d.S - d.D];
      else
        v = variations[((size_t)(b0 + r) * (d.T - 1) + t) * d.V + col - 9 - d.S - d.D - d.A];
      x0[idx] = v;
    }
    __syncthreads();
    if (collect) store_rows(res.x0, x0, in0, in0, t, b0, rows, B);

    for (int l = 0; l < L; ++l) {
      float* h_l = hs + l * kTile * F;
      float* c_l = cs + l * kTile * F;
      const float* a = l == 0 ? x0 : hs + (l - 1) * kTile * F;
      const int k_in = l == 0 ? in0 : F;
      rows_matmul(z, 4 * F, a, k_in, k_in, w.wx[l], h_l, F, F, w.wh[l], 4 * F, w.bh[l]);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kTile * F; idx += blockDim.x) {
        const int r = idx / F, j = idx % F;
        const float* zr = z + r * 4 * F;
        const float i = sigmoidf(zr[j]);
        const float f = sigmoidf(zr[F + j]);
        const float g = tanhf(zr[2 * F + j]);
        const float o = sigmoidf(zr[3 * F + j]);
        const float c_new = f * c_l[idx] + i * g;
        const float h_new = o * tanhf(c_new);
        c_l[idx] = c_new;
        h_l[idx] = h_new;
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
      }
      __syncthreads();
    }

    float* y = z;              // kTile x F
    float* head = z + kTile * F;  // kTile x H
    rows_matmul(y, F, hs + (L - 1) * kTile * F, F, F, w.wb, nullptr, 0, 0, nullptr, F, w.bb);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * F; idx += blockDim.x) y[idx] = fmaxf(y[idx], 0.0f);
    __syncthreads();
    rows_matmul(head, H, y, F, F, w.whead, nullptr, 0, 0, nullptr, H, w.bhead);
    __syncthreads();
    if (collect) {
      store_rows(res.y, y, F, F, t, b0, rows, B);
      store_rows(res.head, head, H, H, t, b0, rows, B);
    }

    // The next state: rotation delta on the axis, translation delta rotated
    // to world by the current angle, style and deformation from the head.
    if (threadIdx.x < kTile) {
      float* s = state + threadIdx.x * SW;
      const float* hr = head + threadIdx.x * H;
      const int ax = d.axis;
      const float theta = s[ax];
      float world[3];
      rotate(ax, cosf(theta), sinf(theta), hr + 6, world);
      if (!d.force_rot) s[ax] = s[ax] + atan2_ref(hr[2 * ax], hr[2 * ax + 1]);
      for (int k = 0; k < 3; ++k) s[3 + k] = s[3 + k] + world[k];
      if (d.force_axis) s[3 + ax] = d.axis_value;
    }
    for (int idx = threadIdx.x; idx < kTile * (d.S + d.D); idx += blockDim.x) {
      const int r = idx / (d.S + d.D), j = idx % (d.S + d.D);
      state[r * SW + 6 + j] = head[r * H + 9 + j];
    }
    __syncthreads();
    store_state(state, out_rot, out_trans, out_style, out_deform, b0, rows, t + 1, d);
  }
}

// (a) The serial reverse chain. Shared memory: dh, dc (L x kTile x F) carry
// gradients; dstate (kTile x SW) the gradient entering the step's outputs;
// dcur (kTile x 6) the current rotation and translation gradients; dz
// (kTile x zw: dz, or d_head | d_y before the layers); dx (kTile x xw).
__global__ void __launch_bounds__(kThreads)
    rollout_bwd_recurrence_kernel(WeightsT w, Residuals res, Dims d,
                                  const float* __restrict__ cot_rot, const float* __restrict__ cot_trans,
                                  const float* __restrict__ cot_style,
                                  const float* __restrict__ cot_deform, float* __restrict__ g_rot,
                                  float* __restrict__ g_trans, float* __restrict__ g_style,
                                  float* __restrict__ g_deform, float* __restrict__ g_actions,
                                  float* __restrict__ g_variations, float* __restrict__ dz_out,
                                  float* __restrict__ dy_out, float* __restrict__ dhead_out,
                                  float* __restrict__ d_final) {
  extern __shared__ float smem[];
  const int F = d.F, L = d.L, SW = d.SW, in0 = d.in0, H = d.H, B = d.batch, T = d.T;
  const int zw = max(4 * F, F + H);
  const int xw = max(in0, F);
  float* dh = smem;
  float* dc = dh + L * kTile * F;
  float* dstate = dc + L * kTile * F;
  float* dcur = dstate + kTile * SW;
  float* dz = dcur + kTile * 6;
  float* dx = dz + kTile * zw;
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, B - b0);
  const int widths[4] = {3, 3, d.S, d.D};
  const float* cots[4] = {cot_rot, cot_trans, cot_style, cot_deform};
  float* outs[4] = {g_rot, g_trans, g_style, g_deform};

  for (int idx = threadIdx.x; idx < 2 * L * kTile * F; idx += blockDim.x) dh[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < kTile * SW; idx += blockDim.x) dstate[idx] = 0.0f;
  __syncthreads();

  for (int t = T - 2; t >= 0; --t) {
    // The gradient entering the step's outputs: the chain plus the loss's.
    for (int idx = threadIdx.x; idx < rows * SW; idx += blockDim.x) {
      const int r = idx / SW, col = idx % SW;
      const int q = col < 3 ? 0 : (col < 6 ? 1 : (col < 6 + d.S ? 2 : 3));
      const int c = col - (q == 0 ? 0 : (q == 1 ? 3 : (q == 2 ? 6 : 6 + d.S)));
      dstate[idx] = dstate[idx] + cots[q][((size_t)(b0 + r) * T + t + 1) * widths[q] + c];
    }
    __syncthreads();

    float* dhead = dz;             // kTile x H
    float* dy = dz + kTile * H;    // kTile x F
    const size_t row0 = (size_t)t * B + b0;
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const float* ds = dstate + r * SW;
      float* dhr = dhead + r * H;
      float* dcr = dcur + r * 6;
      const int ax = d.axis;
      float d_sum[3], cur_rot[3] = {0.0f, 0.0f, 0.0f}, delta[3] = {0.0f, 0.0f, 0.0f};
      float enc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < 3; ++k) d_sum[k] = (d.force_axis && k == ax) ? 0.0f : ds[3 + k];
      if (r < rows) {
        const float* hr = res.head + (row0 + r) * H;
        for (int k = 0; k < 3; ++k) {
          cur_rot[k] = res.cur[0][(row0 + r) * 3 + k];
          delta[k] = hr[6 + k];
        }
        if (!d.force_rot) {
          const float s_a = hr[2 * ax], c_a = hr[2 * ax + 1];
          const float denom = s_a * s_a + c_a * c_a + 1e-20f;
          enc[2 * ax] = ds[ax] * c_a / denom;
          enc[2 * ax + 1] = -ds[ax] * s_a / denom;
        }
      }
      const float ct = cosf(cur_rot[ax]), st = sinf(cur_rot[ax]);
      float d_delta[3];
      rotate(ax, ct, -st, d_sum, d_delta);  // R^T = R(-theta)
      const float d_theta = rotate_dtheta(ax, ct, st, delta, d_sum);
      for (int k = 0; k < 3; ++k) {
        dcr[k] = k == ax ? ds[k] + d_theta : ds[k] + 0.0f;
        dcr[3 + k] = d_sum[k];
        dhr[6 + k] = d_delta[k];
      }
      for (int k = 0; k < 6; ++k) dhr[k] = enc[k];
    }
    for (int idx = threadIdx.x; idx < kTile * (d.S + d.D); idx += blockDim.x) {
      const int r = idx / (d.S + d.D), j = idx % (d.S + d.D);
      dhead[r * H + 9 + j] = dstate[r * SW + 6 + j];
    }
    __syncthreads();
    store_rows(dhead_out, dhead, H, H, t, b0, rows, B);

    // Head and backbone: d_y = d_head whead^T masked by y > 0; d_x = d_y wb^T.
    rows_matmul(dy, F, dhead, H, H, w.whead_t, nullptr, 0, 0, nullptr, F, nullptr);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * F; idx += blockDim.x) {
      const int r = idx / F;
      const float yv = r < rows ? res.y[(row0 + r) * F + idx % F] : 0.0f;
      dy[idx] = dy[idx] * (yv > 0.0f ? 1.0f : 0.0f);
    }
    __syncthreads();
    store_rows(dy_out, dy, F, F, t, b0, rows, B);
    rows_matmul(dx, xw, dy, F, F, w.wb_t, nullptr, 0, 0, nullptr, F, nullptr);
    __syncthreads();

    // LSTM layers, top down.
    for (int l = L - 1; l >= 0; --l) {
      float* dh_l = dh + l * kTile * F;
      float* dc_l = dc + l * kTile * F;
      for (int idx = threadIdx.x; idx < kTile * F; idx += blockDim.x) {
        const int r = idx / F, j = idx % F;
        float i = 0.0f, f = 0.0f, g = 0.0f, o = 0.0f, c_new = 0.0f, c_prev = 0.0f;
        if (r < rows) {
          const size_t row = row0 + r;
          const float* gates = res.gates[l] + row * 4 * F;
          i = gates[j];
          f = gates[F + j];
          g = gates[2 * F + j];
          o = gates[3 * F + j];
          c_new = res.c[l][row * F + j];
          c_prev = t > 0 ? res.c[l][(row - B) * F + j] : w.c_init[l][j];
        }
        const float tanh_c = tanhf(c_new);
        const float d_h = dx[r * xw + j] + dh_l[idx];
        const float d_o = d_h * tanh_c;
        const float d_c = dc_l[idx] + d_h * o * (1.0f - tanh_c * tanh_c);
        const float d_f = d_c * c_prev;
        const float d_i = d_c * g;
        const float d_g = d_c * i;
        dc_l[idx] = d_c * f;
        float* dzr = dz + r * 4 * F;
        dzr[j] = d_i * i * (1.0f - i);
        dzr[F + j] = d_f * f * (1.0f - f);
        dzr[2 * F + j] = d_g * (1.0f - g * g);
        dzr[3 * F + j] = d_o * o * (1.0f - o);
      }
      __syncthreads();
      store_rows(dz_out + (size_t)l * (T - 1) * B * 4 * F, dz, 4 * F, 4 * F, t, b0, rows, B);
      rows_matmul(dh_l, F, dz, 4 * F, 4 * F, w.wh_t[l], nullptr, 0, 0, nullptr, F, nullptr);
      rows_matmul(dx, xw, dz, 4 * F, 4 * F, w.wx_t[l], nullptr, 0, 0, nullptr, l == 0 ? in0 : F,
                  nullptr);
      __syncthreads();
    }

    // The input assembly: sin/cos and box scaling back to the state.
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      const float* dxr = dx + r * xw;
      float* dcr = dcur + r * 6;
      for (int k = 0; k < 3; ++k) {
        const float angle = r < rows ? res.cur[0][(row0 + r) * 3 + k] : 0.0f;
        dcr[k] = dcr[k] + (dxr[2 * k] * cosf(angle) - dxr[2 * k + 1] * sinf(angle));
        dcr[3 + k] = dcr[3 + k] + dxr[6 + k] * d.inv_box[k];
      }
    }
    const int av = d.A + d.V;
    for (int idx = threadIdx.x; idx < rows * av; idx += blockDim.x) {
      const int r = idx / av, j = idx % av;
      const float v = dx[r * xw + 9 + d.S + d.D + j];
      const size_t bt = (size_t)(b0 + r) * (T - 1) + t;
      if (j < d.A)
        g_actions[bt * d.A + j] = v;
      else
        g_variations[bt * d.V + j - d.A] = v;
    }
    __syncthreads();

    // The teacher-forcing pick: the ground-truth input of step t gets
    // use_gt times the gradient, the previous step's output the rest; the
    // ground-truth frame 0 gets both, plus the loss's own gradient there.
    const float use_gt = t < d.gt_count ? 1.0f : 0.0f;
    for (int idx = threadIdx.x; idx < kTile * SW; idx += blockDim.x) {
      const int r = idx / SW, col = idx % SW;
      const float v = col < 6 ? dcur[r * 6 + col] : dx[r * xw + 3 + col];
      if (r < rows) {
        const int q = col < 3 ? 0 : (col < 6 ? 1 : (col < 6 + d.S ? 2 : 3));
        const int c = col - (q == 0 ? 0 : (q == 1 ? 3 : (q == 2 ? 6 : 6 + d.S)));
        const size_t at = ((size_t)(b0 + r) * T + t) * widths[q] + c;
        outs[q][at] = t == 0 ? v + cots[q][at] : use_gt * v;
      }
      dstate[idx] = (1.0f - use_gt) * v;
    }
    __syncthreads();
  }

  // Index T-1 is never a pick input; the carries' final gradients feed the
  // initial-state gradients.
  for (int idx = threadIdx.x; idx < rows * SW; idx += blockDim.x) {
    const int r = idx / SW, col = idx % SW;
    const int q = col < 3 ? 0 : (col < 6 ? 1 : (col < 6 + d.S ? 2 : 3));
    const int c = col - (q == 0 ? 0 : (q == 1 ? 3 : (q == 2 ? 6 : 6 + d.S)));
    outs[q][((size_t)(b0 + r) * T + T - 1) * widths[q] + c] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < 2 * L * rows * F; idx += blockDim.x) {
    const int part = idx / (L * rows * F), rem = idx % (L * rows * F);
    const int l = rem / (rows * F), r = (rem / F) % rows, j = rem % F;
    d_final[(((size_t)part * L + l) * B + b0 + r) * F + j] = (part == 0 ? dh : dc)[(l * kTile + r) * F + j];
  }
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

Dims make_dims(int batch, int T, int F, int L, int S, int D, int A, int V, int gt_count, int axis,
               int force_rot, int force_axis, float axis_value, float ib0, float ib1, float ib2) {
  Dims d;
  d.batch = batch;
  d.T = T;
  d.F = F;
  d.L = L;
  d.S = S;
  d.D = D;
  d.A = A;
  d.V = V;
  d.in0 = 9 + S + D + A + V;
  d.H = 9 + S + D;
  d.SW = 6 + S + D;
  d.gt_count = gt_count;
  d.axis = axis;
  d.force_rot = force_rot;
  d.force_axis = force_axis;
  d.axis_value = axis_value;
  d.inv_box[0] = ib0;
  d.inv_box[1] = ib1;
  d.inv_box[2] = ib2;
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

}  // namespace

// Each launcher runs on `stream` and returns the CUDA error code (0 on
// success). Shapes and limits (F a multiple of 32 up to 256, 1 <= L <= 4,
// the shared memory) are checked by the Python wrapper
// (ops/fused_rollout.py), which allocates every buffer. All tensors f32,
// contiguous: inputs (B, T, .) and (B, T-1, .), outputs (B, T, .).
//
// weights: 5 L + 4 pointers, per layer wx (in_l, 4F), wh (F, 4F), bh (4F),
// h_init (F), c_init (F); then wb (F, F), bb (F), whead (F, H), bhead (H).
// residuals: null, or 7 + 3 L pointers in the order of struct Residuals.
extern "C" int fused_rollout_fwd_launch(const void* const* weights, const void* rot, const void* trans,
                                        const void* style, const void* deform, const void* actions,
                                        const void* variations, void* out_rot, void* out_trans,
                                        void* out_style, void* out_deform, void* const* residuals,
                                        int batch, int T, int F, int L, int S, int D, int A, int V,
                                        int gt_count, int axis, int force_rot, int force_axis,
                                        int collect, float axis_value, float ib0, float ib1, float ib2,
                                        void* stream) {
  const Dims d = make_dims(batch, T, F, L, S, D, A, V, gt_count, axis, force_rot, force_axis,
                           axis_value, ib0, ib1, ib2);
  Weights w = {};
  for (int l = 0; l < L; ++l) {
    w.wx[l] = (const float*)weights[5 * l];
    w.wh[l] = (const float*)weights[5 * l + 1];
    w.bh[l] = (const float*)weights[5 * l + 2];
    w.h_init[l] = (const float*)weights[5 * l + 3];
    w.c_init[l] = (const float*)weights[5 * l + 4];
  }
  w.wb = (const float*)weights[5 * L];
  w.bb = (const float*)weights[5 * L + 1];
  w.whead = (const float*)weights[5 * L + 2];
  w.bhead = (const float*)weights[5 * L + 3];
  const Residuals res = make_residuals(collect ? residuals : nullptr, L);
  const size_t smem =
      sizeof(float) * kTile * (d.SW + d.in0 + 2 * L * F + max(4 * F, F + d.H));
  cudaError_t err = cudaFuncSetAttribute(rollout_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (batch + kTile - 1) / kTile;
  rollout_fwd_kernel<<<tiles, kThreads, smem, (cudaStream_t)stream>>>(
      w, res, d, collect, (const float*)rot, (const float*)trans, (const float*)style,
      (const float*)deform, (const float*)actions, (const float*)variations, (float*)out_rot,
      (float*)out_trans, (float*)out_style, (float*)out_deform);
  return (int)cudaGetLastError();
}

// weights_t: 4 L + 2 pointers, per layer wx^T (4F, in_l), wh^T (4F, F),
// c_init (F), h_init (F); then wb^T (F, F), whead^T (H, F). residuals: as
// the forward's. grads: outputs in the forward's weights order and shapes.
// Scratch: dz (L, T-1, B, 4F), dy (T-1, B, F), dhead (T-1, B, H), d_final
// (2, L, B, F).
extern "C" int fused_rollout_bwd_launch(const void* const* weights_t, void* const* residuals,
                                        const void* cot_rot, const void* cot_trans,
                                        const void* cot_style, const void* cot_deform,
                                        void* const* grads, void* g_rot, void* g_trans, void* g_style,
                                        void* g_deform, void* g_actions, void* g_variations, void* dz,
                                        void* dy, void* dhead, void* d_final, int batch, int T, int F,
                                        int L, int S, int D, int A, int V, int gt_count, int axis,
                                        int force_rot, int force_axis, float ib0, float ib1, float ib2,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Dims d = make_dims(batch, T, F, L, S, D, A, V, gt_count, axis, force_rot, force_axis, 0.0f,
                           ib0, ib1, ib2);
  WeightsT w = {};
  const float* h_init[kMaxLayers] = {};
  for (int l = 0; l < L; ++l) {
    w.wx_t[l] = (const float*)weights_t[4 * l];
    w.wh_t[l] = (const float*)weights_t[4 * l + 1];
    w.c_init[l] = (const float*)weights_t[4 * l + 2];
    h_init[l] = (const float*)weights_t[4 * l + 3];
  }
  w.wb_t = (const float*)weights_t[4 * L];
  w.whead_t = (const float*)weights_t[4 * L + 1];
  const Residuals res = make_residuals(residuals, L);

  const size_t smem = sizeof(float) * kTile *
                      (2 * L * F + d.SW + 6 + max(4 * F, F + d.H) + max(d.in0, F));
  cudaError_t err = cudaFuncSetAttribute(rollout_bwd_recurrence_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (batch + kTile - 1) / kTile;
  rollout_bwd_recurrence_kernel<<<tiles, kThreads, smem, s>>>(
      w, res, d, (const float*)cot_rot, (const float*)cot_trans, (const float*)cot_style,
      (const float*)cot_deform, (float*)g_rot, (float*)g_trans, (float*)g_style, (float*)g_deform,
      (float*)g_actions, (float*)g_variations, (float*)dz, (float*)dy, (float*)dhead,
      (float*)d_final);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int rows = (T - 1) * batch;
  const size_t dz_layer = (size_t)rows * 4 * F;
  GradJobs jobs = {};
  auto add = [&](const float* a, const float* a_init, int shift, int lda, const float* b, int ldb,
                 int K, int M, int N, void* out) {
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
    add(l == 0 ? res.x0 : res.h[l - 1], nullptr, 0, in_l, dz_l, 4 * F, rows, in_l, 4 * F,
        grads[5 * l]);
    add(res.h[l], h_init[l], batch, F, dz_l, 4 * F, rows, F, 4 * F, grads[5 * l + 1]);
    add(nullptr, nullptr, 0, 0, dz_l, 4 * F, rows, 1, 4 * F, grads[5 * l + 2]);
    add(nullptr, nullptr, 0, 0, (const float*)d_final + (size_t)l * batch * F, F, batch, 1, F,
        grads[5 * l + 3]);
    add(nullptr, nullptr, 0, 0, (const float*)d_final + (size_t)(L + l) * batch * F, F, batch, 1,
        F, grads[5 * l + 4]);
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
  return (int)cudaGetLastError();
}
