// Flash attention backward for Hopper (sm_90a), built by nvcc into a shared
// library with a plain C interface (loaded through ctypes, see _build.py):
// f32 at every head dim and bf16 at 16, 32 and 128. bf16 at 64 is
// flash_bwd_sm90.cu's (TMA, wgmma); this library refuses it.
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/flash_attention.py:
//   K2 _bwd_dq_kernel (with _bwd_p_ds)  -> flash_bwd_dq_mma_kernel (bf16),
//                                          flash_bwd_dq_kernel (FMA)
//   K3 _bwd_dkv_kernel (with _bwd_p_ds) -> flash_bwd_dkv_mma_kernel (bf16),
//                                          flash_bwd_dkv_kernel (FMA)
//   K5 scripts/debug_flashbwd.py copy_kernel (the probe of the backward's
//      (rows, 1) column loads)          -> column_broadcast_kernel
// They compute what those kernels compute, the FlashAttention-2 backward
// from the forward's saved lse, with delta = rowsum(do * o) (f32, taken by
// the caller with torch ops, as the reference takes it outside its kernels):
//
//   s  = (q . k) * scale                                    f32
//   p  = exp(s - lse), SELECTED to 0 where the key is invalid (padding past
//        T, lengths, key_mask, causal, window): a fully masked row has
//        lse ~ -1e30, where exp(s - lse) is inf and a multiply by a mask
//        would give NaN
//   dp = do . v                                             f32
//   ds = p * (dp - delta) * scale                           f32
//   dq = sum_k bf16/f32(ds) . k                             ds rounded to k's type
//   dv = sum_q bf16/f32(p)^T . do                           p rounded to do's type
//   dk = sum_q bf16/f32(ds)^T . q                           ds rounded to q's type
//
// with every accumulator in f32, so bf16 rounds where the reference rounds.
//
// The TPU kernels carry their accumulators in VMEM along a sequential grid
// axis; CUDA blocks run in no order, so the loop moves inside the block and
// the two passes stay apart (no atomics: the gradients are the same from
// run to run):
//   dQ:    one CTA per (bh, query tile) walks the key tiles, dq in registers;
//   dK/dV: one CTA per (bh, key tile) walks the query tiles, dk and dv in
//          registers. A key tile wholly past the example's length visits no
//          query tile and writes dk = dv = 0 exactly.
// Tiles above the causal diagonal, wholly behind the window or past the
// length are skipped (exact: they would contribute p = 0).
//
// bf16 at D 16 and 32 runs on the tensor cores: four warps of 16 rows per
// CTA, every product a mma.sync m16n8k16 with f32 accumulation (see "bf16
// on the tensor cores" below). f32, and bf16 at D = 128, run on the CUDA
// cores (f32 FMA): G
// threads share a row (4 for D <= 64, 8 for D = 128 so that the four f32
// row vectors a dK/dV thread holds stay at 64 registers instead of
// spilling), each holding interleaved
// float4 chunks; xor shuffles sum the partial dot products and leave the G
// threads bit-identical scores. The staged tile (K and V for dQ, Q and dO
// for dK/dV) is read as a broadcast: every row of the CTA reads the same
// staged row at the same time.
//
// The training path (bf16, D 64) runs on flash_bwd_sm90.cu; the bounds at
// its shape are worked out there. mma.sync with no load pipeline stays well
// above them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // rows of the staged tile (keys for dQ, queries for dK/dV)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the element type T and back, where the reference casts.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool keep(bool key_ok, int q_pos, int kp, int causal, int window) {
  if (causal && kp > q_pos) return false;
  if (window > 0 && q_pos - kp >= window) return false;
  return key_ok;
}

// Whether key kp exists and is kept by lengths/key_mask.
__device__ __forceinline__ bool key_valid(int kp, int len, int t_len, const int8_t* kmask,
                                          int bh) {
  bool ok = kp < t_len && kp < len;
  if (ok && kmask) ok = kmask[static_cast<size_t>(bh) * t_len + kp] != 0;
  return ok;
}

// Stage rows [r0, r0 + TILE) of one (t_len, D) slab into shared memory as
// f32, [TILE][D]; rows at or past t_len are zero (never read from memory).
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int t_len) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load: 4 f32, 8 bf16
  for (int idx = threadIdx.x; idx < TILE * D / VEC; idx += THREADS) {
    const int r = idx / (D / VEC);
    const int c = (idx % (D / VEC)) * VEC;
    float vals[VEC];
    if (r0 + r < t_len) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + r * D + c + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// This thread's share of row `pos` of a (t_len, D) slab: CH interleaved
// float4 chunks, chunk c at columns (c * G + g) * 4; zero past t_len.
template <typename T, int D, int G>
__device__ __forceinline__ void load_row(float* out, const T* __restrict__ src, int pos,
                                         int t_len, int g) {
  constexpr int CH = D / (4 * G);
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[c * 4 + e] = pos < t_len
          ? to_f32(src[static_cast<size_t>(pos) * D + (c * G + g) * 4 + e]) : 0.f;
}

template <typename T, int D, int G>
__device__ __forceinline__ void store_row(T* dst, const float* val, int pos, int t_len, int g) {
  constexpr int CH = D / (4 * G);
  if (pos >= t_len) return;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(dst + static_cast<size_t>(pos) * D + (c * G + g) * 4 + e, val[c * 4 + e]);
}

// Sum over the G threads of a row; all G end with the same bits.
template <int G>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < G; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// --------------------------------------------------------------- K2: dQ
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ lens,
                    const int8_t* __restrict__ kmask, T* __restrict__ dq, int t_len, int nq,
                    float scale, int causal, int window) {
  constexpr int BQ = THREADS / G;  // query rows per CTA
  constexpr int CH = D / (4 * G);
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [TILE][D]
  float* vs = ks + TILE * D;                     // [TILE][D]
  __shared__ int8_t key_ok[TILE];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;  // heaviest (causal) tiles first
  const int q_pos = q0 + tid / G;
  const bool live = q_pos < t_len;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const int len = lens ? lens[bh] : t_len;
  const float row_lse = live ? lse[static_cast<size_t>(bh) * t_len + q_pos] : 0.f;
  const float row_delta = live ? delta[static_cast<size_t>(bh) * t_len + q_pos] : 0.f;

  float qr[CH * 4], dor[CH * 4], acc[CH * 4];
  load_row<T, D, G>(qr, q + base, q_pos, t_len, g);
  load_row<T, D, G>(dor, dout + base, q_pos, t_len, g);
#pragma unroll
  for (int e = 0; e < CH * 4; ++e) acc[e] = 0.f;

  // key tiles this query tile reaches: not past the length, not above the
  // diagonal, not wholly behind the window
  int kt_end = (min(len, t_len) + TILE - 1) / TILE;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / TILE + 1);
  const int kt_begin = (causal && window > 0) ? max(0, q0 - (window - 1)) / TILE : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(ks, k + base, k0, t_len);
    stage<T, D>(vs, v + base, k0, t_len);
    if (tid < TILE) key_ok[tid] = key_valid(k0 + tid, len, t_len, kmask, bh);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
      float4 kv[CH];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        kv[c] = kr[c * G + g];
        const float4 vv = vr[c * G + g];
        s = fmaf(qr[c * 4 + 0], kv[c].x, s);
        s = fmaf(qr[c * 4 + 1], kv[c].y, s);
        s = fmaf(qr[c * 4 + 2], kv[c].z, s);
        s = fmaf(qr[c * 4 + 3], kv[c].w, s);
        dp = fmaf(dor[c * 4 + 0], vv.x, dp);
        dp = fmaf(dor[c * 4 + 1], vv.y, dp);
        dp = fmaf(dor[c * 4 + 2], vv.z, dp);
        dp = fmaf(dor[c * 4 + 3], vv.w, dp);
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const bool ok = live && keep(key_ok[j] != 0, q_pos, k0 + j, causal, window);
      const float p = ok ? expf(s * scale - row_lse) : 0.f;
      const float ds = round_to<T>(p * (dp - row_delta) * scale);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        acc[c * 4 + 0] = fmaf(ds, kv[c].x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(ds, kv[c].y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(ds, kv[c].z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(ds, kv[c].w, acc[c * 4 + 3]);
      }
    }
  }
  store_row<T, D, G>(dq + base, acc, q_pos, t_len, g);
}

// ------------------------------------------------------------ K3: dK, dV
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ lens,
                     const int8_t* __restrict__ kmask, T* __restrict__ dk,
                     T* __restrict__ dv, int t_len, int nk, float scale, int causal,
                     int window) {
  constexpr int BK = THREADS / G;  // keys per CTA
  constexpr int CH = D / (4 * G);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [TILE][D]
  float* dos = qs + TILE * D;                    // [TILE][D]
  __shared__ float lse_s[TILE];
  __shared__ float delta_s[TILE];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * BK;  // the first key tiles see the most queries
  const int k_pos = k0 + tid / G;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const int len = lens ? lens[bh] : t_len;
  const bool my_key_ok = key_valid(k_pos, len, t_len, kmask, bh);

  float kr[CH * 4], vr[CH * 4], dk_acc[CH * 4], dv_acc[CH * 4];
  load_row<T, D, G>(kr, k + base, k_pos, t_len, g);
  load_row<T, D, G>(vr, v + base, k_pos, t_len, g);
#pragma unroll
  for (int e = 0; e < CH * 4; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  // query tiles that reach this key tile: none when the tile is wholly past
  // the length (dk = dv = 0), none above the diagonal, none wholly past the
  // window of the tile's last key
  const int nq_tiles = (t_len + TILE - 1) / TILE;
  int qt_begin = causal ? k0 / TILE : 0;
  int qt_end = k0 < min(len, t_len) ? nq_tiles : qt_begin;
  if (causal && window > 0) qt_end = min(qt_end, (k0 + BK - 1 + window - 1) / TILE + 1);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(qs, q + base, q0, t_len);
    stage<T, D>(dos, dout + base, q0, t_len);
    if (tid < TILE) {
      const bool live = q0 + tid < t_len;
      lse_s[tid] = live ? lse[static_cast<size_t>(bh) * t_len + q0 + tid] : 0.f;
      delta_s[tid] = live ? delta[static_cast<size_t>(bh) * t_len + q0 + tid] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < TILE; ++i) {
      const int q_pos = q0 + i;
      const float4* qrow = reinterpret_cast<const float4*>(qs + i * D);
      const float4* dorow = reinterpret_cast<const float4*>(dos + i * D);
      float4 qv[CH], dov[CH];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        qv[c] = qrow[c * G + g];
        dov[c] = dorow[c * G + g];
        s = fmaf(kr[c * 4 + 0], qv[c].x, s);
        s = fmaf(kr[c * 4 + 1], qv[c].y, s);
        s = fmaf(kr[c * 4 + 2], qv[c].z, s);
        s = fmaf(kr[c * 4 + 3], qv[c].w, s);
        dp = fmaf(vr[c * 4 + 0], dov[c].x, dp);
        dp = fmaf(vr[c * 4 + 1], dov[c].y, dp);
        dp = fmaf(vr[c * 4 + 2], dov[c].z, dp);
        dp = fmaf(vr[c * 4 + 3], dov[c].w, dp);
      }
      s = row_sum<G>(s);
      dp = row_sum<G>(dp);
      const bool ok = q_pos < t_len && keep(my_key_ok, q_pos, k_pos, causal, window);
      const float p = ok ? expf(s * scale - lse_s[i]) : 0.f;
      const float ds = round_to<T>(p * (dp - delta_s[i]) * scale);
      const float pr = round_to<T>(p);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        dv_acc[c * 4 + 0] = fmaf(pr, dov[c].x, dv_acc[c * 4 + 0]);
        dv_acc[c * 4 + 1] = fmaf(pr, dov[c].y, dv_acc[c * 4 + 1]);
        dv_acc[c * 4 + 2] = fmaf(pr, dov[c].z, dv_acc[c * 4 + 2]);
        dv_acc[c * 4 + 3] = fmaf(pr, dov[c].w, dv_acc[c * 4 + 3]);
        dk_acc[c * 4 + 0] = fmaf(ds, qv[c].x, dk_acc[c * 4 + 0]);
        dk_acc[c * 4 + 1] = fmaf(ds, qv[c].y, dk_acc[c * 4 + 1]);
        dk_acc[c * 4 + 2] = fmaf(ds, qv[c].z, dk_acc[c * 4 + 2]);
        dk_acc[c * 4 + 3] = fmaf(ds, qv[c].w, dk_acc[c * 4 + 3]);
      }
    }
  }
  store_row<T, D, G>(dk + base, dk_acc, k_pos, t_len, g);
  store_row<T, D, G>(dv + base, dv_acc, k_pos, t_len, g);
}

// ------------------------------------------- bf16 on the tensor cores
// K2 and K3 again for bf16 at D 16 and 32: four warps, 16
// rows each (queries for dQ, keys for dK/dV), every product a mma.sync
// m16n8k16 with f32 accumulation. The rows' own operands (q and do for dQ,
// k and v for dK/dV) stay in registers as A fragments for the whole loop;
// the staged tile is bf16 in shared memory, its rows padded by 8 elements.
// The score and dp tiles come out as accumulator fragments, which are
// already laid out as the A operand of the next product once packed to
// bf16 (the FlashAttention-2 register reuse): packing ds and p is exactly
// where the reference rounds them. The B operand of that next product
// (K for dQ, Q and dO for dK/dV) is read down the staged tile's rows, two
// 16-bit loads per register. D = 128 keeps the FMA kernels above: two
// (16 x 128) f32 accumulators per warp beside the score tiles would spill.
constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows = TILE rows per CTA
constexpr int PAD = 8;            // bf16 elements of padding per staged row

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 and packed, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments (16 rows x D, k = the head dim) of rows row[0] (group) and
// row[1] (group + 8) of a (t_len, D) slab, straight from global memory;
// zero past t_len. Fragment e of k-step kk holds row row[e % 2], columns
// kk * 16 + (e / 2) * 8 + 2t and the next.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* src,
                                       const int (&row)[2], int t_len, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e % 2];
      a[kk][e] = r < t_len
          ? load_pair(src + static_cast<size_t>(r) * D + kk * 16 + (e / 2) * 8 + 2 * t) : 0u;
    }
}

// Stage rows [r0, r0 + TILE) of a (t_len, D) bf16 slab into shared memory,
// [TILE][D + PAD]; rows at or past t_len are zero (never read from memory).
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int t_len) {
  for (int idx = threadIdx.x; idx < TILE * D / 8; idx += MMA_THREADS) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len) raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = raw;
  }
}

// The score-shaped product X = A . M^T of this warp's 16 rows against the
// TILE staged rows of m ([TILE][D + PAD]): x[nt] is the accumulator
// fragment of staged rows nt * 8 .. nt * 8 + 7.
template <int D>
__device__ __forceinline__ void rows_times_tile(float (&x)[TILE / 8][4],
                                                const uint32_t (&a)[D / 16][4],
                                                const __nv_bfloat16* m, int grp, int t) {
#pragma unroll
  for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
    const __nv_bfloat16* mr = m + (nt * 8 + grp) * (D + PAD) + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_bf16(x[nt], a[kk], load_pair(mr + kk * 16), load_pair(mr + kk * 16 + 8));
  }
}

// acc += X . M, X (16 x TILE) given as accumulator fragments x (rounded to
// bf16 here, where the reference rounds), M the staged tile [TILE][D + PAD]
// read down its rows as the B operand.
template <int D>
__device__ __forceinline__ void frag_times_tile(float (&acc)[D / 8][4],
                                                const float (&x)[TILE / 8][4],
                                                const __nv_bfloat16* m, int grp, int t) {
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
    const __nv_bfloat16* mc = m + (j * 16 + 2 * t) * (D + PAD) + grp;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const __nv_bfloat16* p = mc + dn * 8;
      mma_bf16(acc[dn], a, pack_pair(p[0], p[D + PAD]),
               pack_pair(p[8 * (D + PAD)], p[9 * (D + PAD)]));
    }
  }
}

// Rows row[0], row[1] of acc fragments to a (t_len, D) bf16 slab.
template <int D>
__device__ __forceinline__ void store_frag(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           const int (&row)[2], int t_len, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t_len) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row[r]) * D + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dn][2 * r], acc[dn][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ lens, const int8_t* __restrict__ kmask,
                        __nv_bfloat16* __restrict__ dq, int t_len, int nq, float scale,
                        int causal, int window) {
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * (D + PAD)];  // K tile, [key][d]
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * (D + PAD)];  // V tile, [key][d]
  __shared__ int8_t key_ok[TILE];

  const int tid = threadIdx.x;
  const int grp = (tid % 32) / 4;
  const int t = tid % 4;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * TILE;  // heaviest (causal) tiles first
  const int row[2] = {q0 + (tid / 32) * 16 + grp, q0 + (tid / 32) * 16 + grp + 8};
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const int len = lens ? lens[bh] : t_len;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row[r] < t_len;
    row_lse[r] = live ? lse[static_cast<size_t>(bh) * t_len + row[r]] : 0.f;
    row_delta[r] = live ? delta[static_cast<size_t>(bh) * t_len + row[r]] : 0.f;
  }

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a<D>(qa, q + base, row, t_len, t);
  load_a<D>(doa, dout + base, row, t_len, t);
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  int kt_end = (min(len, t_len) + TILE - 1) / TILE;
  if (causal) kt_end = min(kt_end, (q0 + TILE - 1) / TILE + 1);
  const int kt_begin = (causal && window > 0) ? max(0, q0 - (window - 1)) / TILE : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D>(ks, k + base, k0, t_len);
    stage_bf16<D>(vs, v + base, k0, t_len);
    if (tid < TILE) key_ok[tid] = key_valid(k0 + tid, len, t_len, kmask, bh);
    __syncthreads();

    float s[TILE / 8][4], dp[TILE / 8][4];
    rows_times_tile<D>(s, qa, ks, grp, t);
    rows_times_tile<D>(dp, doa, vs, grp, t);
    // element e of s[nt]: row row[e / 2], key k0 + nt * 8 + 2t + e % 2
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int j = nt * 8 + 2 * t + e % 2;
        const bool ok = row[r] < t_len && keep(key_ok[j] != 0, row[r], k0 + j, causal, window);
        const float p = ok ? expf(s[nt][e] * scale - row_lse[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[r]) * scale;  // ds
      }
    frag_times_tile<D>(acc, s, ks, grp, t);  // dq += ds . k
  }
  store_frag<D>(dq + base, acc, row, t_len, t);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ lens,
                         const int8_t* __restrict__ kmask, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int t_len, int nk, float scale,
                         int causal, int window) {
  __shared__ __align__(16) __nv_bfloat16 qs[TILE * (D + PAD)];   // Q tile, [query][d]
  __shared__ __align__(16) __nv_bfloat16 dos[TILE * (D + PAD)];  // dO tile, [query][d]
  __shared__ float lse_s[TILE];
  __shared__ float delta_s[TILE];

  const int tid = threadIdx.x;
  const int grp = (tid % 32) / 4;
  const int t = tid % 4;
  const int bh = blockIdx.x / nk;
  const int k0 = (blockIdx.x % nk) * TILE;  // the first key tiles see the most queries
  const int row[2] = {k0 + (tid / 32) * 16 + grp, k0 + (tid / 32) * 16 + grp + 8};
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const int len = lens ? lens[bh] : t_len;
  const bool key_ok[2] = {key_valid(row[0], len, t_len, kmask, bh),
                          key_valid(row[1], len, t_len, kmask, bh)};

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + base, row, t_len, t);
  load_a<D>(va, v + base, row, t_len, t);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  const int nq_tiles = (t_len + TILE - 1) / TILE;
  const int qt_begin = causal ? k0 / TILE : 0;
  int qt_end = k0 < min(len, t_len) ? nq_tiles : qt_begin;
  if (causal && window > 0) qt_end = min(qt_end, (k0 + TILE - 1 + window - 1) / TILE + 1);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D>(qs, q + base, q0, t_len);
    stage_bf16<D>(dos, dout + base, q0, t_len);
    if (tid < TILE) {
      const bool live = q0 + tid < t_len;
      lse_s[tid] = live ? lse[static_cast<size_t>(bh) * t_len + q0 + tid] : 0.f;
      delta_s[tid] = live ? delta[static_cast<size_t>(bh) * t_len + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: this warp's 16 keys against the TILE queries
    float st[TILE / 8][4], dpt[TILE / 8][4];
    rows_times_tile<D>(st, ka, qs, grp, t);
    rows_times_tile<D>(dpt, va, dos, grp, t);
    // element e of st[nt]: key row[e / 2], query q0 + nt * 8 + 2t + e % 2
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int i = nt * 8 + 2 * t + e % 2;
        const bool ok = q0 + i < t_len && keep(key_ok[r], q0 + i, row[r], causal, window);
        const float p = ok ? expf(st[nt][e] * scale - lse_s[i]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[i]) * scale;  // ds^T
      }
    frag_times_tile<D>(dv_acc, st, dos, grp, t);  // dv += p^T . do
    frag_times_tile<D>(dk_acc, dpt, qs, grp, t);  // dk += ds^T . q
  }
  store_frag<D>(dk + base, dk_acc, row, t_len, t);
  store_frag<D>(dv + base, dv_acc, row, t_len, t);
}

// -------------------------------------------- K5: column broadcast probe
// out[r, c] = x[r] for a (rows, 1) f32 column and a (rows, width) output:
// the (bq, 1) -> (bq, D) lse/delta column load the TPU probe checked.
__global__ void column_broadcast_kernel(const float* __restrict__ x, float* __restrict__ out,
                                        long long rows, int width) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx < rows * width) out[idx] = x[idx / width];
}

template <int D>
constexpr int threads_per_row() { return D == 128 ? 8 : 4; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// bf16 at D 16 and 32 on the tensor cores, everything else on the FMA kernels.
template <typename T, int D>
constexpr bool use_mma() { return sizeof(T) == 2 && D <= 64; }

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* lens, const void* kmask,
                      void* dq, int bh, int t_len, float scale, int causal, int window,
                      cudaStream_t stream) {
  if constexpr (use_mma<T, D>()) {
    const int nq = (t_len + TILE - 1) / TILE;
    flash_bwd_dq_mma_kernel<D><<<static_cast<unsigned>(bh) * nq, MMA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(lens), static_cast<const int8_t*>(kmask),
        static_cast<__nv_bfloat16*>(dq), t_len, nq, scale, causal, window);
    return cudaGetLastError();
  } else {
    constexpr int G = threads_per_row<D>();
    const int nq = (t_len + THREADS / G - 1) / (THREADS / G);
    const size_t smem = 2 * TILE * D * sizeof(float);
    auto kernel = flash_bwd_dq_kernel<T, D, G>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(bh) * nq, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const int*>(lens),
        static_cast<const int8_t*>(kmask), static_cast<T*>(dq), t_len, nq, scale, causal,
        window);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* lens,
                       const void* kmask, void* dk, void* dv, int bh, int t_len, float scale,
                       int causal, int window, cudaStream_t stream) {
  if constexpr (use_mma<T, D>()) {
    const int nk = (t_len + TILE - 1) / TILE;
    flash_bwd_dkv_mma_kernel<D><<<static_cast<unsigned>(bh) * nk, MMA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(lens), static_cast<const int8_t*>(kmask),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t_len, nk, scale,
        causal, window);
    return cudaGetLastError();
  } else {
    constexpr int G = threads_per_row<D>();
    const int nk = (t_len + THREADS / G - 1) / (THREADS / G);
    const size_t smem = 2 * TILE * D * sizeof(float);
    auto kernel = flash_bwd_dkv_kernel<T, D, G>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(bh) * nk, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const int*>(lens),
        static_cast<const int8_t*>(kmask), static_cast<T*>(dk), static_cast<T*>(dv), t_len,
        nk, scale, causal, window);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// q, k, v, dout, dq/dk/dv: (bh, t_len, d) contiguous, f32 (is_bf16 = 0) or
// bf16, 16-byte aligned; lse, delta: (bh, t_len) f32; lens: (bh,) int32 or
// null; kmask: (bh, t_len) int8 or null. window <= 0 means none. bf16 at
// d = 64 (flash_bwd_sm90.cu's) returns cudaErrorInvalidValue. Each returns
// a cudaError_t.
#define DL4J_BWD_SWITCH(CALL)                                                \
  switch (d) {                                                               \
    case 16: return is_bf16 ? CALL(__nv_bfloat16, 16) : CALL(float, 16);     \
    case 32: return is_bf16 ? CALL(__nv_bfloat16, 32) : CALL(float, 32);     \
    case 64: return is_bf16 ? cudaErrorInvalidValue : CALL(float, 64);       \
    case 128: return is_bf16 ? CALL(__nv_bfloat16, 128) : CALL(float, 128); \
    default: return cudaErrorInvalidValue;                                   \
  }

int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* lens, const void* kmask,
                      void* dq, int bh, int t_len, int d, int is_bf16, float scale, int causal,
                      int window, void* stream) {
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_DQ(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, lens, kmask, dq, bh, t_len, scale, causal, window, s)
  DL4J_BWD_SWITCH(DL4J_DQ)
#undef DL4J_DQ
}

int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* lens,
                       const void* kmask, void* dk, void* dv, int bh, int t_len, int d,
                       int is_bf16, float scale, int causal, int window, void* stream) {
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_DKV(T, D)                                                                  \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, lens, kmask, dk, dv, bh, t_len, scale, causal, \
                   window, s)
  DL4J_BWD_SWITCH(DL4J_DKV)
#undef DL4J_DKV
}

#undef DL4J_BWD_SWITCH

// x: (rows,) f32; out: (rows, width) f32, both contiguous.
int dl4j_column_broadcast(const void* x, void* out, long long rows, int width, void* stream) {
  if (rows <= 0 || width <= 0) return cudaSuccess;
  const long long n = rows * width;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  column_broadcast_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, width);
  return cudaGetLastError();
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
