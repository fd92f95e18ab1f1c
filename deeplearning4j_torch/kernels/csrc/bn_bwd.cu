// BatchNorm backward for Hopper (sm_90a): the BN-reduce kernels.
//
// Replaces the TPU kernels of scripts/bn_reduce_bench.py:
//   K4a  bn_bwd_pallas -> sum_kernel (:41-63): per-channel f32 sums
//        S1 = sum_r dy[r, c] and S2 = sum_r dy[r, c] * x[r, c] over a
//        row-major (M, C) pair in f32 or bf16;
//   K4b  bn_bwd_pallas -> dx_kernel (:68-81): dx = dy*a + c1 + x*c2,
//        elementwise over (M, C) with per-channel a, c1, c2, in x's dtype.
//
// Both are bound by bytes: K4a reads x and dy once (2*M*C elements), K4b
// reads them and writes dx (3*M*C); each does a few FLOP per element,
// far below the card's ridge.
//
// Design.
// - One launch of K4a. The TPU kernel carries its sums along a sequential
//   grid axis; here a persistent grid splits the channels into chunks of at
//   most 64 16-byte vectors on the bulk route (32 channels on the scalar
//   route) and the rows into contiguous parts: about SMs x occupancy CTAs,
//   or one CTA a SM where the bulk route has one chunk. Thread (lx, ly) of
//   a CTA owns one channel vector and every ty-th row, summing in f32
//   registers in row order; the CTA folds its row lanes in a fixed tree and
//   writes one (2, chunk) partial to the workspace. The fold across CTAs
//   needs no float atomics: each CTA fences and draws an integer ticket for
//   its group of parts; the last of a group folds the group's partials in
//   part order, then draws a ticket of the chunk; the last of the chunk
//   folds the groups in order. Groups are about sqrt(parts) wide, so no CTA
//   folds more than ~20 partials. The bits depend only on (M, C, dtype,
//   route, grid), not on which CTA finished last. Each last CTA resets the
//   counter it drew, so the counters, which live at the head of a
//   workspace that the wrapper caches per (device, stream), are zero again
//   for the next call with no memset. Launches on one stream run one after
//   another, so no two launches ever share a workspace at once.
// - Two routes, chosen by alignment alone (the wrapper picks, the launcher
//   checks, the wrapper counts): "bulk" (C a multiple of 16 bytes, x and dy
//   16-byte aligned): one producer warp streams each CTA's rows, contiguous
//   in memory, with 1-D bulk copies (cp.async.bulk, no tensor map, no
//   per-call host encoding) into a kStages-slot shared-memory ring under
//   full/empty mbarriers, and eight consumer warps sum from shared memory,
//   so the bytes in flight cost no registers; "scalar" (anything else):
//   every thread loads one element of each of kRowsInFlight rows straight
//   from global memory, so any C, any M and any offset work.
// - The fused mode of K4a: given the forward's saved per-channel mean, var,
//   inv = rsqrt(var + eps), a = inv*gamma, gap = msq - mean^2, optional
//   gamma and eps, the last CTA of each chunk also computes, per channel,
//   the algebra of ops/batch_norm.py's bn_backward_coeffs_reference in its
//   op order with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn (no contraction):
//   K4b's operands (a rounded to x's dtype, c1 = dmean/M, c2 = 2*(dmsq/M),
//   f32) and dgamma = d_a*inv, dbeta = S1 rounded to x's dtype, in gamma's
//   dtype. A BatchNorm backward is then two launches: fused K4a, K4b.
// - K4b: each thread owns one channel vector (16 bytes of x's dtype, or
//   one element on the scalar route) and holds a, c1 and c2 for it in
//   registers, with kRowsInFlight rows in flight; the CTAs take blocks of
//   rows in turn, so the grid sweeps memory together, over kDxWaves
//   resident grids' worth of CTAs (measured faster than one resident grid
//   walking contiguous parts); dx leaves with streaming stores. K4b rounds where the reference's bf16 arithmetic rounds: t1 =
//   dy*a, c1 and t3 = x*c2 each rounded to x's dtype, then (t1 + c1) + t3
//   with a rounding after each add, without FMA contraction, so the plain
//   PyTorch version computes the same bits. For f32 the roundings are
//   no-ops.
//
// Tests: on the CPU the wrappers run the plain versions beside them in
// ops/batch_norm.py, which tests/test_torch_batchnorm.py holds against the
// JAX package; on the card chip_smoke.py's phase_bn_kernels holds both
// routes, the fused mode (bit for bit) and K4b (bit for bit) against them,
// and phase_build fails on a spill in any of these kernels.
//
// Plain C interface, loaded through ctypes (deeplearning4j_torch/ops/
// batch_norm.py): every launcher takes PyTorch's current stream and
// returns cudaGetLastError() (0 on success). Kernels live in a named
// namespace so ptxas's mangled names, which chip_smoke's spill gate reads,
// stay stable.

#include <type_traits>

#include "sm90_common.cuh"

namespace dl4j_bn {

constexpr int kThreads = 256;            // consumer threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;            // channel vectors of a chunk
constexpr int kBulkMaxLanes = 64;        // the same on the bulk route
constexpr int kStages = 4;               // bulk route: ring slots
constexpr int kLaneRows = 2;             // bulk route: rows a lane takes a slot
constexpr int kRowsInFlight = 4;         // scalar route and K4b
constexpr int kDxWaves = 4;              // K4b: CTAs per resident CTA slot
constexpr int kMaxCounters = 1 << 16;    // ints at the head of the workspace
constexpr int kMaxDevices = 64;

struct Plan {
  int bulk, vec, tx, ty, chunks, parts, gsize, groups, smem;
  long long rows_per_part, ws_bytes;
};

struct ReduceArgs {
  const void* x;
  const void* dy;
  float* sums;        // (2, C) S1, S2, or null
  int* counters;      // chunks x (groups + 1) tickets, zero between calls
  float* part;        // (2, parts, C) CTA partials
  float* group;       // (2, groups, C) group partials
  long long M, rows_per_part;
  int C, tx, ty, chunks, parts, gsize, groups;
  // the fused mode (coef non-null)
  const float *mean, *var, *inv, *a, *gap;
  const void* gamma;  // (C,) f32 or bf16, or null (lock_gamma_beta)
  int gamma_bf16;
  float eps, m_f;
  float* coef;        // (3, C): a in x's dtype, c1, c2
  void* dgamma;       // (C,) in gamma's dtype, or null
  void* dbeta;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_t(float v);
template <>
__device__ __forceinline__ float round_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The consumer threads' barrier: the bulk route's producer warp never
// joins it.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// VEC consecutive elements: one 16-byte load when VEC * sizeof(T) is 16,
// else scalar loads. From global memory through the read-only path, or
// from shared memory.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_smem(const unsigned char* p,
                                          float (&out)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f(v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = from_f<T>(in[j]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f<T>(in[j]);
  }
}

template <int VEC>
__device__ __forceinline__ void add_row(float (&s1)[VEC], float (&s2)[VEC],
                                        const float (&xv)[VEC],
                                        const float (&gv)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s1[j] = __fadd_rn(s1[j], gv[j]);
    s2[j] = __fadd_rn(s2[j], __fmul_rn(gv[j], xv[j]));
  }
}

// Fold `n` items of two planes (item i of plane k at src[k * plane + (first
// + i) * C + c]) for the chunk's channels [cb, cb + cw), in a fixed order,
// leaving channel cb + c's two sums at scratch[c] and scratch[h + c] (h >=
// cw and >= kThreads). A chunk at most kThreads wide gets kThreads / cw
// lanes: lane il sums items il, il + lanes, ... in order, then a fixed
// tree folds the lanes; a wider chunk gets one thread a channel.
__device__ void fold(const float* src, long long plane, int first, int n,
                     int C, int cb, int cw, float* scratch, int h, int tid) {
  const float* p = src + (long long)first * C + cb;
  if (cw > kThreads) {
    for (int c = tid; c < cw; c += kThreads) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        a1 = __fadd_rn(a1, __ldcg(p + (long long)i * C + c));
        a2 = __fadd_rn(a2, __ldcg(p + plane + (long long)i * C + c));
      }
      scratch[c] = a1;
      scratch[h + c] = a2;
    }
    consumer_sync();
    return;
  }
  const int lanes = kThreads / cw;
  const int il = tid / cw, cl = tid % cw;
  if (il < lanes) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
    for (int i = il; i < n; i += lanes) {
      a1 = __fadd_rn(a1, __ldcg(p + (long long)i * C + cl));
      a2 = __fadd_rn(a2, __ldcg(p + plane + (long long)i * C + cl));
    }
    scratch[tid] = a1;
    scratch[h + tid] = a2;
  }
  consumer_sync();
  int top = 1;
  while (top < lanes) top <<= 1;
  for (int s = top / 2; s > 0; s >>= 1) {
    if (il < s && il + s < lanes) {
      scratch[tid] = __fadd_rn(scratch[tid], scratch[tid + s * cw]);
      scratch[h + tid] = __fadd_rn(scratch[h + tid], scratch[h + tid + s * cw]);
    }
    consumer_sync();
  }
}

// The per-channel algebra of the fused mode, in bn_backward_coeffs_
// reference's op order.
template <typename T>
__device__ void coeffs(const ReduceArgs& p, int c, float S1, float S2) {
  const int C = p.C;
  const float s1 = round_t<T>(S1), s2 = round_t<T>(S2);
  const float mean = p.mean[c], inv = p.inv[c], a = p.a[c], gap = p.gap[c];
  const float d_a = __fsub_rn(s2, __fmul_rn(mean, s1));
  float d_inv = d_a;
  if (p.gamma != nullptr) {
    const float g =
        p.gamma_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.gamma)[c])
            : static_cast<const float*>(p.gamma)[c];
    d_inv = __fmul_rn(d_a, g);
  }
  const float dvar = __fmul_rn(
      d_inv, __fdiv_rn(__fmul_rn(-0.5f, inv), __fadd_rn(p.var[c], p.eps)));
  const float w = gap > 0.f ? 1.f : (gap == 0.f ? 0.5f : 0.f);
  const float dmsq = __fmul_rn(dvar, w);
  const float dmean = __fsub_rn(__fmul_rn(-a, s1),
                                __fmul_rn(__fmul_rn(2.f, mean), dmsq));
  p.coef[c] = round_t<T>(a);
  p.coef[C + c] = __fdiv_rn(dmean, p.m_f);
  p.coef[2 * C + c] = __fmul_rn(2.f, __fdiv_rn(dmsq, p.m_f));
  if (p.dgamma != nullptr) {
    const float dg = __fmul_rn(d_a, inv);
    if (p.gamma_bf16) {
      static_cast<__nv_bfloat16*>(p.dgamma)[c] = __float2bfloat16_rn(dg);
      static_cast<__nv_bfloat16*>(p.dbeta)[c] = __float2bfloat16_rn(s1);
    } else {
      static_cast<float*>(p.dgamma)[c] = dg;
      static_cast<float*>(p.dbeta)[c] = s1;
    }
  }
}

// Everything after a CTA's rows: fold its row lanes into one partial, then
// the ticketed folds across CTAs, then (last CTA of the chunk) the sums
// and, in the fused mode, the per-channel algebra. Consumer threads only;
// scratch holds 2 * kThreads * VEC floats.
template <typename T, int VEC>
__device__ void finish(const ReduceArgs& p, float* scratch, int* last,
                       const float (&s1)[VEC], const float (&s2)[VEC],
                       int tid) {
  const int C = p.C, tx = p.tx, ty = p.ty;
  const int lx = tid % tx, ly = tid / tx;
  const int ch = blockIdx.x, part = blockIdx.y;
  const int cb = ch * tx * VEC;
  const int cw = min(C - cb, tx * VEC);
  // the CTA's row lanes, folded in a fixed tree
  float* m1 = scratch + tid * VEC;
  float* m2 = m1 + kThreads * VEC;
  if (ly < ty) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m1[j] = s1[j];
      m2[j] = s2[j];
    }
  }
  consumer_sync();
  int top = 1;
  while (top < ty) top <<= 1;
  for (int s = top / 2; s > 0; s >>= 1) {
    if (ly < s && ly + s < ty) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        m1[j] = __fadd_rn(m1[j], m1[s * tx * VEC + j]);
        m2[j] = __fadd_rn(m2[j], m2[s * tx * VEC + j]);
      }
    }
    consumer_sync();
  }
  const long long pplane = (long long)p.parts * C;
  if (ly == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = cb + lx * VEC + j;
      if (lx * VEC + j < cw) {
        p.part[(long long)part * C + c] = m1[j];
        p.part[pplane + (long long)part * C + c] = m2[j];
      }
    }
  }
  // the ticket of this CTA's group of parts
  const int g = part / p.gsize;
  const int n_g = min(p.gsize, p.parts - g * p.gsize);
  int* cnt = p.counters + (long long)ch * (p.groups + 1);
  __threadfence();
  consumer_sync();
  if (tid == 0) *last = atomicAdd(cnt + g, 1) == n_g - 1;
  consumer_sync();
  if (!*last) return;
  __threadfence();
  // scratch: the folded sums of channel cb + c at [c] and [h + c]
  const int h = kThreads * VEC;
  fold(p.part, pplane, g * p.gsize, n_g, C, cb, cw, scratch, h, tid);
  if (tid == 0) cnt[g] = 0;
  if (p.groups > 1) {
    const long long gplane = (long long)p.groups * C;
    for (int c = tid; c < cw; c += kThreads) {
      p.group[(long long)g * C + cb + c] = scratch[c];
      p.group[gplane + (long long)g * C + cb + c] = scratch[h + c];
    }
    __threadfence();
    consumer_sync();
    if (tid == 0) *last = atomicAdd(cnt + p.groups, 1) == p.groups - 1;
    consumer_sync();
    if (!*last) return;
    __threadfence();
    fold(p.group, gplane, 0, p.groups, C, cb, cw, scratch, h, tid);
    if (tid == 0) cnt[p.groups] = 0;
  }
  for (int c = tid; c < cw; c += kThreads) {
    const float r1 = scratch[c], r2 = scratch[h + c];
    if (p.sums != nullptr) {
      p.sums[cb + c] = r1;
      p.sums[C + cb + c] = r2;
    }
    if (p.coef != nullptr) coeffs<T>(p, cb + c, r1, r2);
  }
}

// K4a, bulk route. Threads 0..255 consume, warp 8 produces. Slot s of the
// ring holds R = ty * kLaneRows rows of the chunk for x, then for dy, each
// row tx 16-byte vectors wide.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads + 32)
bn_reduce_bulk_kernel(const ReduceArgs p) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int C = p.C, tx = p.tx, ty = p.ty;
  const int ch = blockIdx.x;
  const int cv = C / VEC;
  const int w = min(tx, cv - ch * tx);         // vectors in this chunk
  const int R = ty * kLaneRows;
  const int row_smem = tx * 16;
  const int slot_bytes = R * row_smem;          // one tensor's share of a slot
  const long long r0 = (long long)blockIdx.y * p.rows_per_part;
  const long long r1 = min(p.M, r0 + p.rows_per_part);
  const long long n_iter = r0 < r1 ? (r1 - r0 + R - 1) / R : 0;
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  if (tid >= kThreads) {                        // the producer warp
    const int lane = tid - kThreads;
    const long long c0 = (long long)ch * tx * VEC;
    const uint32_t row_bytes = w * 16;
    for (long long i = 0; i < n_iter; ++i) {
      const int s = (int)(i % kStages);
      const long long start = r0 + i * R;
      const int n = (int)min((long long)R, r1 - start);
      if (lane == 0) {
        mbar_wait(empty0 + 8 * s, (uint32_t)(((i / kStages) & 1) ^ 1));
        mbar_expect_tx(full0 + 8 * s, 2 * n * (int)row_bytes);
      }
      __syncwarp();
      const uint32_t dx_ = smem_u32(ring + (long long)s * 2 * slot_bytes);
      const uint32_t dg_ = dx_ + slot_bytes;
      if (p.chunks == 1) {                      // the slot's rows are contiguous
        if (lane == 0) {
          bulk_load(dx_, x + start * C, n * row_bytes, full0 + 8 * s);
          bulk_load(dg_, dy + start * C, n * row_bytes, full0 + 8 * s);
        }
      } else {
        for (int r = lane; r < n; r += 32) {
          bulk_load(dx_ + r * row_smem, x + (start + r) * C + c0, row_bytes,
                    full0 + 8 * s);
          bulk_load(dg_ + r * row_smem, dy + (start + r) * C + c0, row_bytes,
                    full0 + 8 * s);
        }
      }
    }
    return;
  }
  const int lx = tid % tx, ly = tid / tx;
  const bool live = ly < ty && lx < w;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  for (long long i = 0; i < n_iter; ++i) {
    const int s = (int)(i % kStages);
    const int n = (int)min((long long)R, r1 - (r0 + i * R));
    mbar_wait(full0 + 8 * s, (uint32_t)((i / kStages) & 1));
    if (live) {
      const unsigned char* xs = ring + (long long)s * 2 * slot_bytes + lx * 16;
      const unsigned char* gs = xs + slot_bytes;
      float xv[kLaneRows][VEC], gv[kLaneRows][VEC];
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        const int r = ly + k * ty;
        if (r < n) {
          load_smem<T, VEC>(xs + r * row_smem, xv[k]);
          load_smem<T, VEC>(gs + r * row_smem, gv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k)
        if (ly + k * ty < n) add_row<VEC>(s1, s2, xv[k], gv[k]);
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
  }
  consumer_sync();                              // the ring becomes scratch
  finish<T, VEC>(p, reinterpret_cast<float*>(ring), &last, s1, s2, tid);
}

// K4a, scalar route: every thread loads one element of each of its rows
// itself.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_reduce_scalar_kernel(const ReduceArgs p) {
  __shared__ __align__(16) float scratch[2 * kThreads];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int C = p.C, tx = p.tx, ty = p.ty;
  const int lx = tid % tx, ly = tid / tx;
  const int c = blockIdx.x * tx + lx;
  const long long r0 = (long long)blockIdx.y * p.rows_per_part;
  const long long r1 = min(p.M, r0 + p.rows_per_part);
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  float s1[1] = {0.f}, s2[1] = {0.f};
  if (ly < ty && c < C) {
    long long r = r0 + ly;
    for (; r + (kRowsInFlight - 1) * ty < r1; r += kRowsInFlight * ty) {
      float xv[kRowsInFlight][1], gv[kRowsInFlight][1];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        load_vec<T, 1>(x + (r + k * ty) * C + c, xv[k]);
        load_vec<T, 1>(dy + (r + k * ty) * C + c, gv[k]);
      }
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) add_row<1>(s1, s2, xv[k], gv[k]);
    }
    for (; r < r1; r += ty) {
      float xv[1], gv[1];
      load_vec<T, 1>(x + r * C + c, xv);
      load_vec<T, 1>(dy + r * C + c, gv);
      add_row<1>(s1, s2, xv, gv);
    }
  }
  finish<T, 1>(p, scratch, &last, s1, s2, tid);
}

// K4b. Thread (lx, ly) of CTA (chunk, b) owns channel vector chunk * tx +
// lx and rows ly, ly + ty, ... of row blocks b, b + gridDim.y, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ a, const float* __restrict__ c1,
             const float* __restrict__ c2, T* __restrict__ dx, long long M,
             int C, int tx, int ty) {
  const int lx = threadIdx.x % tx, ly = threadIdx.x / tx;
  const int c0 = (blockIdx.x * tx + lx) * VEC;
  if (ly >= ty || c0 >= C) return;
  float av[VEC], t2[VEC], cv2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    av[j] = __ldg(a + c0 + j);
    t2[j] = round_t<T>(__ldg(c1 + c0 + j));
    cv2[j] = __ldg(c2 + c0 + j);
  }
  // rows r, r + ty, ... (N of them) loaded first, then formed and stored
  auto rows = [&](long long r, auto n) {
    constexpr int N = decltype(n)::value;
    float xv[N][VEC], gv[N][VEC];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      load_vec<T, VEC>(x + (r + k * ty) * C + c0, xv[k]);
      load_vec<T, VEC>(dy + (r + k * ty) * C + c0, gv[k]);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t1 = round_t<T>(__fmul_rn(gv[k][j], av[j]));
        const float t3 = round_t<T>(__fmul_rn(xv[k][j], cv2[j]));
        out[j] = __fadd_rn(round_t<T>(__fadd_rn(t1, t2[j])), t3);
      }
      store_vec<T, VEC>(dx + (r + k * ty) * C + c0, out);
    }
  };
  // the CTAs take B-row blocks in turn, so the grid sweeps memory together
  const long long B = (long long)kRowsInFlight * ty;
  for (long long base = blockIdx.y * B; base < M; base += gridDim.y * B) {
    if (base + B <= M) {
      rows(base + ly, std::integral_constant<int, kRowsInFlight>());
    } else {
      for (long long r = base + ly; r < M; r += ty)
        rows(r, std::integral_constant<int, 1>());
    }
  }
}

// ------------------------------------------------------------------- host
// The host code's per-device caches are statics of functions in an unnamed
// namespace, so they have internal linkage. A template function's statics
// at namespace scope would be unified by the dynamic loader across every
// copy of this library in a process (STB_GNU_UNIQUE), and a second copy
// would then skip setting its own kernels' shared-memory limit.
namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev < 0 ? 0 : dev % kMaxDevices;
}

int sm_count() {
  static std::atomic<int> cache[kMaxDevices];
  const int dev = current_device();
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
    cache[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Resident CTAs a SM for `kernel` at this block size and dynamic shared
// memory, as the runtime reports it, cached per device in `cache`; sets the
// kernel's dynamic shared memory limit first where it needs more than 48 KB.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, std::atomic<int>* cache,
              std::atomic<uint64_t>& smem_done) {
  const int dev = current_device();
  int k = cache[dev].load(std::memory_order_relaxed);
  if (k == 0) {
    if (smem > 48 * 1024) allow_smem_once(kernel, smem, smem_done);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, threads, smem);
    if (k < 1) k = 1;
    cache[dev].store(k, std::memory_order_relaxed);
  }
  return k;
}

constexpr int kRingBytes = kStages * 2 * kThreads * kLaneRows * 16;

template <typename T>
int reduce_occupancy(bool bulk) {
  static std::atomic<int> bulk_cache[kMaxDevices], scalar_cache[kMaxDevices];
  static std::atomic<uint64_t> smem_done{0}, unused{0};
  if (bulk)
    return occupancy(bn_reduce_bulk_kernel<T, 16 / sizeof(T)>, kThreads + 32,
                     kRingBytes, bulk_cache, smem_done);
  return occupancy(bn_reduce_scalar_kernel<T>, kThreads, 0, scalar_cache,
                   unused);
}

template <typename T, int VEC>
int dx_occupancy() {
  static std::atomic<int> cache[kMaxDevices];
  static std::atomic<uint64_t> unused{0};
  return occupancy(bn_dx_kernel<T, VEC>, kThreads, 0, cache, unused);
}

// Channel lanes and row lanes of a CTA, and the channel chunks, for C
// elements in vectors of vec.
void lanes(int C, int vec, int max_lanes, Plan* pl) {
  const int cv = (C + vec - 1) / vec;
  pl->vec = vec;
  pl->tx = cv < max_lanes ? cv : max_lanes;
  pl->ty = kThreads / pl->tx;
  pl->chunks = (cv + pl->tx - 1) / pl->tx;
}

// Contiguous row parts: about `ctas` CTAs over the chunks, each part at
// least `min_rows` rows.
void row_parts(long long M, long long ctas, long long min_rows, Plan* pl) {
  long long want = ctas / pl->chunks;
  long long most = (M + min_rows - 1) / min_rows;
  long long parts = want < most ? want : most;
  if (parts < 1) parts = 1;
  if (parts > 65535) parts = 65535;
  pl->rows_per_part = M > 0 ? (M + parts - 1) / parts : 0;
  pl->parts = M > 0 ? (int)((M + pl->rows_per_part - 1) / pl->rows_per_part) : 1;
}

// The plan of one K4a call; returns cudaErrorInvalidValue for the bulk
// route on operands it cannot take, or a grid the counters cannot hold.
cudaError_t reduce_plan(const void* x, const void* dy, long long M, int C,
                        int is_bf16, int bulk, Plan* pl) {
  const int vec16 = is_bf16 ? 8 : 4;
  if (bulk && !(C % vec16 == 0 && aligned16(x) && aligned16(dy)))
    return cudaErrorInvalidValue;
  pl->bulk = bulk;
  lanes(C, bulk ? vec16 : 1, bulk ? kBulkMaxLanes : kMaxLanes, pl);
  const int occ = is_bf16 ? reduce_occupancy<__nv_bfloat16>(bulk)
                          : reduce_occupancy<float>(bulk);
  // one channel chunk on the bulk route: one CTA a SM, whose 64 KB ring
  // keeps enough bytes in flight (more CTAs measured slower there); else
  // the occupancy, so the chunks' CTAs fill the card
  const int ctas_per_sm = bulk && pl->chunks == 1 ? 1 : occ;
  row_parts(M, (long long)sm_count() * ctas_per_sm,
            (long long)pl->ty * (bulk ? kLaneRows : kRowsInFlight), pl);
  int gs = 1;
  while (gs * gs < pl->parts) ++gs;
  pl->gsize = gs;
  pl->groups = (pl->parts + gs - 1) / gs;
  if ((long long)pl->chunks * (pl->groups + 1) > kMaxCounters)
    return cudaErrorInvalidValue;
  pl->smem = bulk ? kStages * 2 * pl->ty * kLaneRows * pl->tx * 16 : 0;
  pl->ws_bytes = 4LL * kMaxCounters
                 + 4LL * 2 * ((long long)pl->parts + pl->groups) * C;
  return cudaSuccess;
}

template <typename T>
void launch_reduce(const Plan& pl, const ReduceArgs& args, cudaStream_t st) {
  const dim3 grid(pl.chunks, pl.parts);
  if (pl.bulk)
    bn_reduce_bulk_kernel<T, 16 / sizeof(T)>
        <<<grid, kThreads + 32, pl.smem, st>>>(args);
  else
    bn_reduce_scalar_kernel<T><<<grid, kThreads, 0, st>>>(args);
}

template <typename T, int VEC>
void launch_dx(const void* x, const void* dy, const float* a, const float* c1,
               const float* c2, void* dx, long long M, int C,
               cudaStream_t st) {
  Plan pl;
  lanes(C, VEC, kMaxLanes, &pl);
  // kDxWaves resident grids' worth of CTAs (measured faster than one)
  row_parts(M, (long long)sm_count() * dx_occupancy<T, VEC>() * kDxWaves,
            (long long)pl.ty * kRowsInFlight, &pl);
  bn_dx_kernel<T, VEC><<<dim3(pl.chunks, pl.parts), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), a, c1, c2,
      static_cast<T*>(dx), M, C, pl.tx, pl.ty);
}

}  // namespace
}  // namespace dl4j_bn

using namespace dl4j_bn;

extern "C" {

// K4a in one launch. sums (2, C) f32 = (sum dy, sum dy*x) over the rows of
// (M, C) x, dy, if not null. With coef not null, the fused mode: coef (3,
// C) f32 = (a in x's dtype, c1, c2) and, with gamma, dgamma and dbeta in
// gamma's dtype, from the saved per-channel mean, var, inv, a, gap. `bulk`
// 1 takes the bulk route (C a multiple of 16 bytes, x and dy 16-byte
// aligned, else cudaErrorInvalidValue), 0 the scalar route. ws: ws_bytes
// of workspace, its first 4 * 65536 bytes zero between calls (the kernel
// leaves them so), at least 4 * 65536 + 16 * max(C, 8 * SMs * 512) bytes
// (every grid's partials: a SM holds at most 8 CTAs of 256 threads, and a
// chunk is at most 512 channels); cudaErrorInvalidValue if the plan needs
// more.
int dl4j_bn_reduce(const void* x, const void* dy, float* sums, void* ws,
                   long long ws_bytes, long long M, int C, int is_bf16,
                   int bulk,
                   const float* mean, const float* var, const float* inv,
                   const float* a, const float* gap, const void* gamma,
                   int gamma_bf16, double eps, float* coef, void* dgamma,
                   void* dbeta, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C == 0) return (int)cudaGetLastError();
  Plan pl;
  const cudaError_t e = reduce_plan(x, dy, M, C, is_bf16, bulk, &pl);
  if (e != cudaSuccess) return (int)e;
  if (pl.ws_bytes > ws_bytes) return (int)cudaErrorInvalidValue;
  ReduceArgs args;
  args.x = x;
  args.dy = dy;
  args.sums = sums;
  args.counters = static_cast<int*>(ws);
  args.part = reinterpret_cast<float*>(static_cast<int*>(ws) + kMaxCounters);
  args.group = args.part + 2LL * pl.parts * C;
  args.M = M;
  args.rows_per_part = pl.rows_per_part;
  args.C = C;
  args.tx = pl.tx;
  args.ty = pl.ty;
  args.chunks = pl.chunks;
  args.parts = pl.parts;
  args.gsize = pl.gsize;
  args.groups = pl.groups;
  args.mean = mean;
  args.var = var;
  args.inv = inv;
  args.a = a;
  args.gap = gap;
  args.gamma = gamma;
  args.gamma_bf16 = gamma_bf16;
  args.eps = (float)eps;
  args.m_f = (float)M;
  args.coef = coef;
  args.dgamma = gamma != nullptr ? dgamma : nullptr;
  args.dbeta = gamma != nullptr ? dbeta : nullptr;
  if (is_bf16)
    launch_reduce<__nv_bfloat16>(pl, args, stream);
  else
    launch_reduce<float>(pl, args, stream);
  return (int)cudaGetLastError();
}

// K4b: dx = dy*a + c1 + x*c2 over (M, C), a/c1/c2 (C,) f32, dx in x's
// dtype. `vector` 1 takes 16-byte vectors (the caller checked C and the
// alignment of all six pointers), 0 one element a lane.
int dl4j_bn_dx(const void* x, const void* dy, const float* a, const float* c1,
               const float* c2, void* dx, long long M, int C, int is_bf16,
               int vector, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M == 0 || C == 0) return (int)cudaGetLastError();
  if (is_bf16) {
    if (vector)
      launch_dx<__nv_bfloat16, 8>(x, dy, a, c1, c2, dx, M, C, stream);
    else
      launch_dx<__nv_bfloat16, 1>(x, dy, a, c1, c2, dx, M, C, stream);
  } else {
    if (vector)
      launch_dx<float, 4>(x, dy, a, c1, c2, dx, M, C, stream);
    else
      launch_dx<float, 1>(x, dy, a, c1, c2, dx, M, C, stream);
  }
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
