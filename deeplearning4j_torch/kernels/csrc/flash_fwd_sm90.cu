// Flash attention forward for Hopper (sm_90a), bf16 at head dims 64 and 128:
// TMA loads into a shared-memory K/V ring fed by a producer warpgroup, both
// products on wgmma, under warp specialisation. Built by nvcc into a shared
// library with a plain C interface (loaded through ctypes, see _build.py).
// f32 at every head dim and bf16 at 16 and 32 stay on flash_fwd.cu.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/flash_attention.py:
// _fwd_kernel (line 41, launched by _flash_fwd at line 189). It computes
// what flash_fwd.cu's kernels compute, the same contract:
//
//   s   = (q . k) * scale                          f32
//   s   = -1e30 where the key is invalid           past T, past lens, key
//                                                  mask 0, above the causal
//                                                  diagonal, behind the window
//   m   = running row max, l = running row sum,    f32
//   acc = acc * alpha + bf16(p) . v                P rounded to bf16 first
//   o   = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))   natural log
//
// so a row whose every key is masked outputs o = 0 and lse <= -1e29.
//
// Design. A CTA owns 128 query rows of one (batch, head) and has three
// warpgroups. Warpgroup 2 is the producer: after setmaxnreg gives its
// registers away, one thread loads Q once and then K and V tiles by TMA
// into a ring of STAGES slots, each slot guarded by a "full" mbarrier (the
// TMA transaction bytes) and an "empty" one (every consumer thread arrives
// when done with it), waited on with phase parity. Warpgroups 0 and 1 are
// consumers of 64 query rows each. Per key tile a consumer runs
//   S = Q.K^T  as D/16 wgmma m64n{BK}k16, Q and K both from shared memory
//              (K-major, 128-byte swizzle, as TMA wrote them);
//   softmax    in exp2 units on the special-function unit (ex2.approx),
//              scale*log2(e) folded into one multiply (into the exponent's
//              FMA on an interior tile), the row max and sum over the four
//              threads of a row by two xor shuffles; the S accumulator,
//              rounded to bf16 in pairs, is already wgmma's register A
//              fragment for the next product;
//   O += P.V   as BK/16 wgmma m64n{D}k16 with A = P from registers and
//              B = V straight from the ring as an MN-major operand (the
//              transpose-B immediate): V is never transposed.
// The tiles are 3-D TMA boxes of (64 columns, rows, 1) over (D, T, B*H), so
// rows past T arrive as zeros and never read the next head; D = 128 is two
// 64-column boxes because a 128-byte swizzle holds 128 bytes of a row.
//
// Masking runs only where it is needed: each key tile is classified once
// per consumer warpgroup. A tile wholly inside the length, wholly at or
// below the diagonal and wholly inside the window (with no key mask and a
// positive scale) runs with no per-element test; the diagonal tile, the
// tile that straddles the length and the window's edge test each element
// against its row's interval of valid keys, with no branch; under a key
// mask every tile is tested, the mask's bits read before the tile's
// products. p is selected to 0 on a masked key (never taken from
// exp(-1e30 - m)). Tiles above the diagonal, behind the window or past the
// length are never loaded. Query tiles are issued heaviest first within
// each (batch, head).
//
// Bound on an H100 SXM at the serving shape (B*H = 128, T = 1024, D = 64,
// bf16, causal): q, k, v and o plus lse are 67.6 MB, 0.0202 ms at 3.35
// TB/s; the causal pairs need 4*D*T(T+1)/2 FLOP per head, 17.2 GFLOP, 0.0174
// ms at 989 TFLOP/s. So bytes bound it, and by little: the design reads each
// K/V tile once per 128 query rows through TMA (no register or instruction
// cost for the copies), overlaps the next tile's load with this tile's
// products, and keeps S and P in registers. What stands between it and the
// bound, by its structure: in a consumer warpgroup the softmax and the two
// products run one after the other, so the tensor cores wait through every
// softmax; one CTA fills an SM (168 registers a thread), so each CTA's wait
// for its first Q and K/V tiles and its stores of o are not hidden behind
// another CTA's work. Not done yet: ping-pong between the two consumer
// warpgroups and softmax/wgmma overlap within one, a persistent grid, o
// stored by TMA, clusters with multicast.

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;                        // query rows per CTA
constexpr int CONSUMERS = 2 * 128;             // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;       // and the producer warpgroup
constexpr int STAGES = 2;                      // K/V ring depth
constexpr int PRODUCER_REGS = 24;              // setmaxnreg: 128 * 24 +
constexpr int CONSUMER_REGS = 240;             //   256 * 240 = 384 * 168

template <int D>
struct Tile {
  static constexpr int BK = D == 64 ? 128 : 64;       // keys per tile
  static constexpr int CH = D / 64;                   // 64-column boxes a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;         // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  // the tiles, the barriers, and slack to align the tiles to 1024 bytes
  // (the 128-byte swizzle's period, which TMA and wgmma both assume)
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES + 1024;
};

// ---------------------------------------------------------------- kernel
// The online softmax of one score tile s (BK keys from k0) for this
// thread's two rows row0 and row0 + 8 (exp2 units: c = scale * log2(e), m2
// the running max of s * c): updates m2 and this thread's share of l,
// rescales oacc, and leaves P rounded to bf16 in pa as wgmma's A fragments,
// pa[j] for keys 16j..16j+15 of the tile. An interior tile (c > 0) takes
// its max on the raw scores and folds c into the exponent's one FMA, p =
// 2^(s * c - m2), a multiply an element fewer. MASKED tests each element:
// a row's valid keys are one interval [lo, hi] (the length, the diagonal,
// the window), so the test is two compares against constants and a bit of
// the key mask (kbits, all ones without one), with no branch: a branch on
// a per-element test diverges across the diagonal.
template <int BK, int D, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&oacc)[D / 2],
                                             uint32_t (&pa)[BK / 16][4], float (&m2)[2],
                                             float (&l)[2], float c, int k0, int row0,
                                             int t, int lim, uint32_t kbits, int causal,
                                             int window) {
  // valid keys of row r as offsets from this thread's first key k0 + 2t,
  // whose own keys are at offsets 8j + e % 2
  const int kb = k0 + 2 * t;
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    hi[r] = (causal ? min(lim - 1, row) : lim - 1) - kb;
    lo[r] = window > 0 ? row - window + 1 - kb : -BK;
  }
  float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      float x = MASKED ? s[4 * j + e] * c : s[4 * j + e];
      if (MASKED) {
        const int kr = 8 * j + e % 2;
        const bool ok = (kr >= lo[r]) & (kr <= hi[r])
                        & (((kbits >> (2 * j + e % 2)) & 1u) != 0);
        x = ok ? x : NEG_INF;
      }
      s[4 * j + e] = x;
      tmax[r] = fmaxf(tmax[r], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the four threads of a row hold its keys between them
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    if (!MASKED) tmax[r] *= c;
    const float m_new = fmaxf(m2[r], tmax[r]);
    alpha[r] = ex2(m2[r] - m_new);
    m2[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      const float x = s[4 * j + e];
      float p = MASKED ? ex2(x - m2[r]) : ex2(fmaf(x, c, -m2[r]));
      // a row with no valid key yet has m2 == NEG_INF, where the exp2
      // would be 1 for a masked key: select 0 on the masked score instead
      if (MASKED) p = x == NEG_INF ? 0.f : p;
      s[4 * j + e] = p;
      psum[r] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    oacc[4 * j + 0] *= alpha[0];
    oacc[4 * j + 1] *= alpha[0];
    oacc[4 * j + 2] *= alpha[1];
    oacc[4 * j + 3] *= alpha[1];
  }
  // the accumulators of key columns 16j..16j+7 and 16j+8..16j+15 are the
  // A fragment's column halves for k-step j
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    pa[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
    pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const int* __restrict__ lens, const int8_t* __restrict__ kmask,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int t_len,
                      int nq, float c, int causal, int window) {
  using TL = Tile<D>;
  constexpr int BK = TL::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + TL::Q_BYTES;                 // slot st: + st * KV_BYTES
  const uint32_t v_s = k_s + STAGES * TL::KV_BYTES;
  const uint32_t bars = v_s + STAGES * TL::KV_BYTES;     // full[], empty[], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - blockIdx.x % nq) * BQ;  // heaviest query tile first
  const int lim = min(lens ? lens[bh] : t_len, t_len);
  int kt_begin, kt_end;
  key_tile_range<BQ, BK>(q0, lim, causal, window, &kt_begin, &kt_end);
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);                        // full: the producer
      mbar_init(bars + 8 * (STAGES + st), CONSUMERS);     // empty: every consumer
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != CONSUMERS) return;
    mbar_expect_tx(q_bar, TL::Q_BYTES);
#pragma unroll
    for (int ch = 0; ch < TL::CH; ++ch)
      tma_load(q_s + ch * BQ * ROW_BYTES, &qmap, q_bar, ch * 64, q0, bh);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) & 1) ^ 1);  // slot free
      const uint32_t full = bars + 8 * st;
      mbar_expect_tx(full, 2 * TL::KV_BYTES);
      const int k0 = (kt_begin + i) * BK;
#pragma unroll
      for (int ch = 0; ch < TL::CH; ++ch) {
        const uint32_t at = st * TL::KV_BYTES + ch * BK * ROW_BYTES;
        tma_load(k_s + at, &kmap, full, ch * 64, k0, bh);
        tma_load(v_s + at, &vmap, full, ch * 64, k0, bh);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int wr0 = q0 + 64 * wg;               // this warpgroup's first row
  const int row0 = wr0 + 16 * warp + g;       // this thread's rows: row0, row0 + 8
  const int8_t* km = kmask ? kmask + static_cast<size_t>(bh) * t_len : nullptr;
  const uint32_t q_wg = q_s + 64 * wg * ROW_BYTES;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m2[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    const int k0 = (kt_begin + i) * BK;
    // the key mask is read before the products, while few registers are live
    const uint32_t kbits = km != nullptr ? key_bits<BK>(km, k0 + 2 * t, lim) : ~0u;
    const uint32_t k_st = k_s + st * TL::KV_BYTES;
    const uint32_t v_st = v_s + st * TL::KV_BYTES;

    // S = Q.K^T: k-step kk is 32 bytes into the swizzled rows of box kk / 4
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(s, smem_desc(q_wg + (kk / 4) * BQ * ROW_BYTES + col, 16, 1024),
               smem_desc(k_st + (kk / 4) * BK * ROW_BYTES + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // (a scale <= 0 runs every tile masked, where c multiplies each score)
    const bool interior = c > 0.f && km == nullptr && k0 + BK <= lim
                          && (!causal || k0 + BK - 1 <= wr0)
                          && (window <= 0 || wr0 + 63 - k0 < window);
    uint32_t pa[BK / 16][4];
    if (interior)
      softmax_tile<BK, D, false>(s, oacc, pa, m2, l, c, k0, row0, t, lim, kbits, causal,
                                 window);
    else
      softmax_tile<BK, D, true>(s, oacc, pa, m2, l, c, k0, row0, t, lim, kbits, causal,
                                window);

    // O += P.V: k-step j is keys 16j..16j+15, two 1024-byte groups of 8
    // rows; the second 64 columns of V (D = 128) are the next box
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_rs(oacc, pa[j], smem_desc(v_st + j * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pa);
    mbar_arrive(bars + 8 * (STAGES + st));  // this thread is done with the slot
  }

  const size_t base = static_cast<size_t>(bh) * t_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    __nv_bfloat16* orow = o + (base + row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
    // back to natural-log units; a row with no valid key keeps -1e30
    if (t == 0)
      lse[base + row] = (m2[r] <= NEG_INF ? NEG_INF : m2[r] * LN2) + lg2(lc) * LN2;
  }
}

// ------------------------------------------------------------------- host
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lens,
                   const void* kmask, void* o, void* lse, int bh, int t_len, float scale,
                   int causal, int window, cudaStream_t stream) {
  using TL = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(encode, &qmap, q, bh, t_len, D, BQ)
      || !encode_map(encode, &kmap, k, bh, t_len, D, TL::BK)
      || !encode_map(encode, &vmap, v, bh, t_len, D, TL::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90_kernel<D>;
  static std::atomic<uint64_t> smem_set{0};  // per head dim
  const cudaError_t e = allow_smem_once(kernel, TL::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  const int nq = (t_len + BQ - 1) / BQ;
  kernel<<<static_cast<unsigned>(bh) * nq, THREADS, TL::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<const int*>(lens), static_cast<const int8_t*>(kmask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), t_len, nq, scale * LOG2E,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of dl4j_flash_fwd (flash_fwd.cu): q, k, v, o (bh, t_len, d)
// contiguous bf16, 16-byte aligned; lens (bh,) int32 or null; kmask
// (bh, t_len) int8 or null; lse (bh, t_len) f32; window <= 0 means none.
// Takes bf16 (is_bf16 = 1) at d = 64 or 128 only, else returns
// cudaErrorInvalidValue. Returns a cudaError_t.
int dl4j_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* lens,
                        const void* kmask, void* o, void* lse, int bh, int t_len, int d,
                        int is_bf16, float scale, int causal, int window, void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, lens, kmask, o, lse, bh, t_len, scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, lens, kmask, o, lse, bh, t_len, scale, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
