// Flash attention forward (f32; bf16 at head dims 16 and 32) for Hopper
// (sm_90a), built by nvcc into a shared library with a plain C interface
// (loaded through ctypes, see _build.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/flash_attention.py:
// _fwd_kernel (launched by _flash_fwd). It computes what that kernel
// computes, not a block-by-block copy of its TPU grid:
//
//   s   = (q . k) * scale                          f32, whatever the input type
//   s   = -1e30 where the key is invalid           padding past T, lengths,
//                                                  key_mask, causal, window
//   m   = running row max, l = running row sum,    all f32
//   acc = acc * alpha + bf16/f32(p) . v            P rounded to V's type first
//   o   = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
//
// so a row whose every key is masked (or whose length is 0) outputs 0.
//
// Both paths: one CTA per (bh, 64-row query tile) walks the key tiles of 64
// keys, staging K and V in shared memory, with the running statistics in
// registers. Key tiles above the causal diagonal, wholly behind the sliding
// window, or wholly past the example's length are never loaded (exact: such
// a tile would contribute p = 0 and alpha = 1). Query tiles are issued
// heaviest first (the last tile of the causal triangle first) so the tail
// of the grid is short.
//
// bf16 at head dims 16 and 32 (bf16 at 64 and 128, the serving path, is
// flash_fwd_sm90.cu: TMA and wgmma): four warps, 16 query rows each. Both
// products run on the tensor cores as mma.sync m16n8k16 with f32
// accumulation: Q's fragments stay in registers for the whole key loop; the
// score tile's accumulator fragments are rescaled, exponentiated and packed
// to bf16 in registers, where they are already laid out as the A operand of
// P.V (the FlashAttention-2 register reuse), so P never touches shared
// memory. K rows and V^T rows are padded by 8 elements so the fragment
// loads of a warp hit 32 distinct banks.
//
// f32: four threads per query row on the CUDA cores (f32 FMA), each holding
// a quarter of the row's q and acc in interleaved float4 chunks, so the four
// threads of a row read one contiguous 64-byte run of a key row; two xor
// shuffles sum the partial dot products and leave all four threads
// bit-identical scores, so their max and exp decisions agree.
//
// Neither path is on the main path's shape (bf16, D = 64), whose bound
// flash_fwd_sm90.cu's note states.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per CTA
constexpr int BK = 64;             // keys per shared-memory tile
constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernel uses

// First and one-past-last key tile a query tile at q0 must visit.
__device__ __forceinline__ void key_tile_range(int q0, int len, int t_len, int causal,
                                               int window, int* begin, int* end) {
  int e = (min(len, t_len) + BK - 1) / BK;
  if (causal) e = min(e, (q0 + BQ - 1) / BK + 1);
  int b = 0;
  if (causal && window > 0) b = max(0, q0 - (window - 1)) / BK;
  *begin = b;
  *end = e;
}

// Whether each key of the tile at k0 exists and is kept by lengths/key_mask.
__device__ __forceinline__ void load_key_ok(int8_t* key_ok, int k0, int len, int t_len,
                                            const int8_t* kmask, int bh) {
  const int j = threadIdx.x;
  if (j < BK) {
    const int kp = k0 + j;
    bool ok = kp < t_len && kp < len;
    if (ok && kmask) ok = kmask[static_cast<size_t>(bh) * t_len + kp] != 0;
    key_ok[j] = ok;
  }
}

__device__ __forceinline__ bool keep(bool key_ok, int q_pos, int kp, int causal, int window) {
  if (causal && kp > q_pos) return false;
  if (window > 0 && q_pos - kp >= window) return false;
  return key_ok;
}

// ---------------------------------------------------------------- f32 path
constexpr int G = 4;                 // threads per query row
constexpr int F32_THREADS = BQ * G;  // 256

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     const int8_t* __restrict__ kmask, float* __restrict__ o,
                     float* __restrict__ lse, int t_len, int nq, float scale,
                     int causal, int window) {
  constexpr int CH = D / (4 * G);  // float4 chunks each thread owns: 1, 2, 4, 8
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* vs = ks + BK * D;                       // [BK][D]
  __shared__ int8_t key_ok[BK];

  const int tid = threadIdx.x;
  const int row = tid / G;
  const int g = tid % G;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;
  const int q_pos = q0 + row;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const int len = lens ? lens[bh] : t_len;

  float qr[CH * 4];
  float acc[CH * 4];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d0 = (c * G + g) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c * 4 + e] = q_pos < t_len ? q[base + static_cast<size_t>(q_pos) * D + d0 + e] : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }

  int kt_begin, kt_end;
  key_tile_range(q0, len, t_len, causal, window, &kt_begin, &kt_end);
  float m = NEG_INF;
  float l = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += F32_THREADS) {
      const int kp = k0 + idx / D;
      float kk = 0.f, vv = 0.f;
      if (kp < t_len) {
        const size_t at = base + static_cast<size_t>(kp) * D + idx % D;
        kk = k[at];
        vv = v[at];
      }
      ks[idx] = kk;
      vs[idx] = vv;
    }
    load_key_ok(key_ok, k0, len, t_len, kmask, bh);
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kv = kr[c * G + g];
        part = fmaf(qr[c * 4 + 0], kv.x, part);
        part = fmaf(qr[c * 4 + 1], kv.y, part);
        part = fmaf(qr[c * 4 + 2], kv.z, part);
        part = fmaf(qr[c * 4 + 3], kv.w, part);
      }
      s[j] = part;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
    }

    uint64_t valid = 0;
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const bool ok = keep(key_ok[j] != 0, q_pos, k0 + j, causal, window);
      s[j] = ok ? s[j] * scale : NEG_INF;
      valid |= static_cast<uint64_t>(ok) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // a row with no valid key yet has m_new == NEG_INF, where
      // exp(s - m_new) would be 1 for a masked key: zero p explicitly
      const float p = (valid >> j) & 1 ? expf(s[j] - m_new) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int e = 0; e < CH * 4; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = vr[c * G + g];
        acc[c * 4 + 0] = fmaf(s[j], vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(s[j], vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(s[j], vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(s[j], vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (q_pos < t_len) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d0 = (c * G + g) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[base + static_cast<size_t>(q_pos) * D + d0 + e] = acc[c * 4 + e] / lc;
    }
    if (g == 0) lse[static_cast<size_t>(bh) * t_len + q_pos] = m + logf(lc);
  }
}

// --------------------------------------------------------------- bf16 path
constexpr int WARPS = BQ / 16;          // 16 query rows per warp
constexpr int BF16_THREADS = WARPS * 32;  // 128

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 f32. Fragment owners: lane = 4 * group + t; a holds rows
// group/group+8, cols 2t..2t+1 and 2t+8..2t+9; b holds rows 2t..2t+1 and
// 2t+8..2t+9 of col group; d holds rows group/group+8, cols 2t..2t+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 and packed, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
                      const int8_t* __restrict__ kmask, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int t_len, int nq, float scale,
                      int causal, int window) {
  constexpr int KS = D + 8;   // padded K row, in elements
  constexpr int VS = BK + 8;  // padded V^T row
  constexpr int DK = D / 16;  // k-steps of Q.K^T over the head dim
  constexpr int DN = D / 8;   // n-tiles of O over the head dim
  constexpr int NT = BK / 8;  // n-tiles of S over the keys
  constexpr int VEC = 8;      // bf16 per 16-byte load
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KS];  // K tile, [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[D * VS];   // V tile transposed, [d][key]
  __shared__ int8_t key_ok[BK];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int grp = (tid % 32) / 4;
  const int t = tid % 4;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;
  const int row[2] = {q0 + warp * 16 + grp, q0 + warp * 16 + grp + 8};
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const int len = lens ? lens[bh] : t_len;

  // Q as A fragments, straight from global memory, for the whole key loop
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = kk * 16 + h * 8 + 2 * t;
        qa[kk][h * 2 + r] = row[r] < t_len
            ? load_pair(q + base + static_cast<size_t>(row[r]) * D + col) : 0u;
      }
    }
  }

  float oacc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dn][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  int kt_begin, kt_end;
  key_tile_range(q0, len, t_len, causal, window, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D / VEC; idx += BF16_THREADS) {
      const int j = idx / (D / VEC);
      const int d = (idx % (D / VEC)) * VEC;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < t_len) {
        const size_t at = base + static_cast<size_t>(k0 + j) * D + d;
        kv = *reinterpret_cast<const uint4*>(k + at);
        vv = *reinterpret_cast<const uint4*>(v + at);
      }
      *reinterpret_cast<uint4*>(ks + j * KS + d) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) vt[(d + e) * VS + j] = ve[e];
    }
    load_key_ok(key_ok, k0, len, t_len, kmask, bh);
    __syncthreads();

    // S = Q.K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + grp) * KS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                 load_pair(kr + kk * 16), load_pair(kr + kk * 16 + 8));
    }

    // mask, scale, and the tile's row max; element e of s[nt] is row
    // row[e / 2], key k0 + nt * 8 + 2 * t + e % 2
    uint32_t valid[2] = {0u, 0u};
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int j = nt * 8 + 2 * t + e % 2;
        const bool ok = keep(key_ok[j] != 0, row[r], k0 + j, causal, window);
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        valid[r] |= static_cast<uint32_t>(ok) << (nt * 2 + e % 2);
        tmax[r] = fmaxf(tmax[r], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four threads of a row group hold its 64 keys between them
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        // zero masked p explicitly: with no valid key yet, m == NEG_INF
        // and exp(s - m) would be 1
        const float p = (valid[r] >> (nt * 2 + e % 2)) & 1u ? expf(s[nt][e] - m[r]) : 0.f;
        s[nt][e] = p;
        psum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      oacc[dn][0] *= alpha[0];
      oacc[dn][1] *= alpha[0];
      oacc[dn][2] *= alpha[1];
      oacc[dn][3] *= alpha[1];
    }

    // O += P.V: the S fragments of key n-tiles 2j and 2j+1 are the A
    // fragment of key k-step j once rounded to bf16
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const __nv_bfloat16* vr = vt + (dn * 8 + grp) * VS + j * 16 + 2 * t;
        mma_bf16(oacc[dn], a0, a1, a2, a3, load_pair(vr), load_pair(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= t_len) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(
          o + base + static_cast<size_t>(row[r]) * D + dn * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[dn][2 * r] / lc, oacc[dn][2 * r + 1] / lc);
    }
    if (t == 0) lse[static_cast<size_t>(bh) * t_len + row[r]] = m[r] + logf(lc);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* lens,
                       const void* kmask, void* o, void* lse, int bh, int t_len,
                       float scale, int causal, int window, cudaStream_t stream) {
  const int nq = (t_len + BQ - 1) / BQ;
  const size_t smem = 2 * BK * D * sizeof(float);
  auto kernel = flash_fwd_f32_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(bh) * nq, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<const int8_t*>(kmask), static_cast<float*>(o),
      static_cast<float*>(lse), t_len, nq, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* lens,
                        const void* kmask, void* o, void* lse, int bh, int t_len,
                        float scale, int causal, int window, cudaStream_t stream) {
  const int nq = (t_len + BQ - 1) / BQ;
  flash_fwd_bf16_kernel<D><<<static_cast<unsigned>(bh) * nq, BF16_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<const int8_t*>(kmask), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), t_len, nq, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, t_len, d) contiguous, f32 (is_bf16 = 0) or bf16, 16-byte
// aligned; lens: (bh,) int32 or null; kmask: (bh, t_len) int8 or null;
// lse: (bh, t_len) f32. window <= 0 means none. bf16 at d = 64 or 128
// returns cudaErrorInvalidValue (dl4j_flash_fwd_sm90 takes it). Returns a
// cudaError_t.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, const void* lens,
                   const void* kmask, void* o, void* lse, int bh, int t_len, int d,
                   int is_bf16, float scale, int causal, int window, void* stream) {
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_FLASH_CASE(D)                                                              \
  case D:                                                                               \
    return is_bf16                                                                      \
        ? launch_bf16<D>(q, k, v, lens, kmask, o, lse, bh, t_len, scale, causal, window, s) \
        : launch_f32<D>(q, k, v, lens, kmask, o, lse, bh, t_len, scale, causal, window, s);
  // bf16 at 64 and 128 is flash_fwd_sm90.cu's
#define DL4J_FLASH_F32_CASE(D)                                                          \
  case D:                                                                               \
    return is_bf16                                                                      \
        ? cudaErrorInvalidValue                                                         \
        : launch_f32<D>(q, k, v, lens, kmask, o, lse, bh, t_len, scale, causal, window, s);
  switch (d) {
    DL4J_FLASH_CASE(16)
    DL4J_FLASH_CASE(32)
    DL4J_FLASH_F32_CASE(64)
    DL4J_FLASH_F32_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DL4J_FLASH_F32_CASE
#undef DL4J_FLASH_CASE
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
