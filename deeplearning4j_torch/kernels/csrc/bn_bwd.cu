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
// - The TPU kernel carries its sums along a sequential grid axis. CUDA
//   blocks run in no order, so K4a takes two passes and no atomics: pass 1
//   (bn_reduce_partial) gives each block a chunk of channels and a strided
//   share of the rows ("part"); each thread walks its rows accumulating in
//   f32 registers, the block folds its rows in a fixed tree in shared
//   memory and writes one partial row per part to an f32 workspace; pass 2
//   (bn_reduce_final) folds the parts of each channel in a fixed order.
//   The block shape depends only on (M, C, dtype, alignment), so the sums
//   are the same bits from run to run.
// - Shapes run from M = 1,605,632 x C = 64 (the ResNet-50 stem) to
//   M = 6,272 x C = 2048 (stage 4): a block is 256 threads as TY rows x TX
//   channel lanes, TX the smallest power of two (up to 32) that covers the
//   channel vectors, so narrow C splits rows and wide C splits channels;
//   the number of parts fills the card with about eight blocks per SM
//   while giving each thread at least eight rows.
// - Each lane loads 16 bytes along C (8 bf16 or 4 f32) when C is a
//   multiple of that and the pointers are 16-byte aligned; otherwise the
//   same kernels run with one element per lane, so any C and any M work.
// - K4b loads its per-channel operands as 16-byte vectors beside the
//   16-byte loads of x and dy (8 channels a thread in bf16, 4 in f32).
// - K4b rounds where the reference's bf16 arithmetic rounds: t1 = dy*a,
//   c1 and t3 = x*c2 each rounded to x's dtype, then (t1 + c1) + t3 with a
//   rounding after each add; products and sums are __fmul_rn/__fadd_rn
//   (no FMA contraction), so the plain PyTorch version computes the same
//   bits. For f32 the roundings are no-ops.
//
// Plain C interface, loaded through ctypes (deeplearning4j_torch/ops/
// batch_norm.py): every launcher takes PyTorch's current stream and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;
constexpr int kTargetBlocks = 132 * 8;
constexpr int kMinRowsPerThread = 8;
constexpr int kFinalLanes = 32;
constexpr int kFinalRows = 8;
constexpr int kRowsInFlight = 4;

struct ReduceCfg {
  int vec;     // elements per lane load
  int tx;      // channel lanes per block
  int ty;      // row lanes per block
  int chunks;  // channel chunks (grid.x)
  int parts;   // row parts (grid.y)
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

// VEC consecutive f32 per-channel values: 16-byte loads when VEC is a
// multiple of 4 (the caller checked the alignment), else scalar loads.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = __ldg(p + j);
  }
}

// VEC consecutive elements of a row: one 16-byte load when VEC * sizeof(T)
// is 16, else scalar loads.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = from_f<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f<T>(in[j]);
  }
}

// Pass 1 of K4a. Block (tx, ty) = (channel lane, row lane); grid (chunks,
// parts). ws holds two (parts, C) f32 planes: S1 partials, then S2.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_reduce_partial(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ ws, long long M, int C, int tx,
                  int ty) {
  __shared__ float sm[2][kThreads * kMaxVec];
  const int lx = threadIdx.x % tx;
  const int ly = threadIdx.x / tx;
  const int c0 = (blockIdx.x * tx + lx) * VEC;
  const bool live = c0 < C;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (live) {
    const long long step = (long long)gridDim.y * ty;
    long long r = (long long)blockIdx.y * ty + ly;
    // kRowsInFlight rows' loads issued before their sums, added in row
    // order: more bytes in flight per thread, the same order of adds
    for (; r + (kRowsInFlight - 1) * step < M; r += kRowsInFlight * step) {
      float xv[kRowsInFlight][VEC], gv[kRowsInFlight][VEC];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        load_vec<T, VEC>(x + (r + k * step) * C + c0, xv[k]);
        load_vec<T, VEC>(dy + (r + k * step) * C + c0, gv[k]);
      }
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1[j] = __fadd_rn(s1[j], gv[k][j]);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(gv[k][j], xv[k][j]));
        }
      }
    }
    for (; r < M; r += step) {
      float xv[VEC], gv[VEC];
      load_vec<T, VEC>(x + r * C + c0, xv);
      load_vec<T, VEC>(dy + r * C + c0, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1[j] = __fadd_rn(s1[j], gv[j]);
        s2[j] = __fadd_rn(s2[j], __fmul_rn(gv[j], xv[j]));
      }
    }
  }
  float* m1 = sm[0] + (ly * tx + lx) * VEC;
  float* m2 = sm[1] + (ly * tx + lx) * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m1[j] = s1[j];
    m2[j] = s2[j];
  }
  __syncthreads();
  // fixed tree over the row lanes (ty is a power of two)
  for (int s = ty / 2; s > 0; s >>= 1) {
    if (ly < s) {
      const float* o1 = m1 + s * tx * VEC;
      const float* o2 = m2 + s * tx * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        m1[j] = __fadd_rn(m1[j], o1[j]);
        m2[j] = __fadd_rn(m2[j], o2[j]);
      }
    }
    __syncthreads();
  }
  if (ly == 0 && live) {
    const long long plane = (long long)gridDim.y * C;
    float* w1 = ws + (long long)blockIdx.y * C + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      w1[j] = m1[j];
      w1[plane + j] = m2[j];
    }
  }
}

// Pass 2 of K4a: out[0, c] = sum over parts of ws[0, p, c], out[1, c]
// likewise, in a fixed order. Block (kFinalLanes, kFinalRows).
__global__ void __launch_bounds__(kFinalLanes* kFinalRows)
bn_reduce_final(const float* __restrict__ ws, float* __restrict__ out,
                int parts, int C) {
  __shared__ float sm[2][kFinalRows][kFinalLanes];
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int c = blockIdx.x * kFinalLanes + lx;
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    const long long plane = (long long)parts * C;
    for (int p = ly; p < parts; p += kFinalRows) {
      a1 = __fadd_rn(a1, ws[(long long)p * C + c]);
      a2 = __fadd_rn(a2, ws[plane + (long long)p * C + c]);
    }
  }
  sm[0][ly][lx] = a1;
  sm[1][ly][lx] = a2;
  __syncthreads();
  for (int s = kFinalRows / 2; s > 0; s >>= 1) {
    if (ly < s) {
      sm[0][ly][lx] = __fadd_rn(sm[0][ly][lx], sm[0][ly + s][lx]);
      sm[1][ly][lx] = __fadd_rn(sm[1][ly][lx], sm[1][ly + s][lx]);
    }
    __syncthreads();
  }
  if (ly == 0 && c < C) {
    out[c] = sm[0][0][lx];
    out[C + c] = sm[1][0][lx];
  }
}

// K4b. Thread v handles elements [v*VEC, v*VEC + VEC) of the flat (M, C)
// array; VEC divides C, so they share one row and channels c..c+VEC-1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ a, const float* __restrict__ c1,
             const float* __restrict__ c2, T* __restrict__ dx,
             long long n_vec, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const long long e0 = v * VEC;
    const int c = (int)(e0 % C);
    float xv[VEC], gv[VEC], av[VEC], c1v[VEC], c2v[VEC], out[VEC];
    load_vec<T, VEC>(x + e0, xv);
    load_vec<T, VEC>(dy + e0, gv);
    load_f32<VEC>(a + c, av);
    load_f32<VEC>(c1 + c, c1v);
    load_f32<VEC>(c2 + c, c2v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t1 = round_t<T>(__fmul_rn(gv[j], av[j]));
      const float t2 = round_t<T>(c1v[j]);
      const float t3 = round_t<T>(__fmul_rn(xv[j], c2v[j]));
      out[j] = __fadd_rn(round_t<T>(__fadd_rn(t1, t2)), t3);
    }
    store_vec<T, VEC>(dx + e0, out);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements per lane: 16 bytes of x's dtype when C allows it and every
// pointer given is 16-byte aligned, else 1.
int pick_vec(int C, int is_bf16, std::initializer_list<const void*> ptrs) {
  const int vec = is_bf16 ? 8 : 4;
  if (C % vec) return 1;
  for (const void* p : ptrs)
    if (!aligned16(p)) return 1;
  return vec;
}

ReduceCfg reduce_cfg(long long M, int C, int vec) {
  ReduceCfg cfg;
  cfg.vec = vec;
  const int cv = (C + vec - 1) / vec;
  cfg.tx = 1;
  while (cfg.tx < cv && cfg.tx < 32) cfg.tx <<= 1;
  cfg.ty = kThreads / cfg.tx;
  cfg.chunks = (cv + cfg.tx - 1) / cfg.tx;
  const long long rows_per_part = (long long)cfg.ty * kMinRowsPerThread;
  long long most = (M + rows_per_part - 1) / rows_per_part;
  long long want = (kTargetBlocks + cfg.chunks - 1) / cfg.chunks;
  long long parts = want < most ? want : most;
  cfg.parts = (int)(parts < 1 ? 1 : parts);
  return cfg;
}

template <typename T, int VEC>
void launch_reduce(const void* x, const void* dy, float* ws, float* out,
                   long long M, int C, const ReduceCfg& cfg,
                   cudaStream_t stream) {
  dim3 grid(cfg.chunks, cfg.parts);
  bn_reduce_partial<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, M, C, cfg.tx,
      cfg.ty);
  dim3 fgrid((C + kFinalLanes - 1) / kFinalLanes);
  dim3 fblock(kFinalLanes, kFinalRows);
  bn_reduce_final<<<fgrid, fblock, 0, stream>>>(ws, out, cfg.parts, C);
}

template <typename T, int VEC>
void launch_dx(const void* x, const void* dy, const float* a,
               const float* c1, const float* c2, void* dx, long long M,
               int C, cudaStream_t stream) {
  const long long n_vec = M * C / VEC;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  bn_dx_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), a, c1, c2,
      static_cast<T*>(dx), n_vec, C);
}

}  // namespace

extern "C" {

// Floats of workspace that dl4j_bn_reduce needs for these operands.
long long dl4j_bn_reduce_workspace(const void* x, const void* dy, long long M,
                                   int C, int is_bf16) {
  const ReduceCfg cfg = reduce_cfg(M, C, pick_vec(C, is_bf16, {x, dy}));
  return 2LL * cfg.parts * C;
}

// K4a: out (2, C) f32 = (sum dy, sum dy*x) over the rows of (M, C) x, dy.
int dl4j_bn_reduce(const void* x, const void* dy, float* out, float* ws,
                   long long M, int C, int is_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int vec = pick_vec(C, is_bf16, {x, dy});
  const ReduceCfg cfg = reduce_cfg(M, C, vec);
  if (M == 0 || C == 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * 2 * (size_t)C, stream);
    return (int)cudaGetLastError();
  }
  if (is_bf16) {
    if (vec == 8)
      launch_reduce<__nv_bfloat16, 8>(x, dy, ws, out, M, C, cfg, stream);
    else
      launch_reduce<__nv_bfloat16, 1>(x, dy, ws, out, M, C, cfg, stream);
  } else {
    if (vec == 4)
      launch_reduce<float, 4>(x, dy, ws, out, M, C, cfg, stream);
    else
      launch_reduce<float, 1>(x, dy, ws, out, M, C, cfg, stream);
  }
  return (int)cudaGetLastError();
}

// K4b: dx = dy*a + c1 + x*c2 over (M, C), a/c1/c2 (C,) f32, dx in x's
// dtype.
int dl4j_bn_dx(const void* x, const void* dy, const float* a, const float* c1,
               const float* c2, void* dx, long long M, int C, int is_bf16,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M == 0 || C == 0) return (int)cudaGetLastError();
  const int vec = pick_vec(C, is_bf16, {x, dy, dx, a, c1, c2});
  if (is_bf16) {
    if (vec == 8)
      launch_dx<__nv_bfloat16, 8>(x, dy, a, c1, c2, dx, M, C, stream);
    else
      launch_dx<__nv_bfloat16, 1>(x, dy, a, c1, c2, dx, M, C, stream);
  } else {
    if (vec == 4)
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
