// Flash attention backward for Hopper (sm_90a), bf16 at head dim 64: TMA
// loads into shared-memory rings fed by a producer warpgroup, every product
// on wgmma, under warp specialisation. Built by nvcc into a shared library
// with a plain C interface (loaded through ctypes, see _build.py). f32 at
// every head dim and bf16 at 16, 32 and 128 stay on flash_bwd.cu: at 128
// the dK/dV kernel's two (64 x 128) f32 accumulators a warpgroup spilled
// (424 bytes of spill stores from ptxas on sm_90a, with query tiles of 32),
// so the kernels are written for D a multiple of 64 but built at 64 only.
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/flash_attention.py:
//   K3 _bwd_dkv_kernel (line 330, launched by _flash_bwd_pallas at line 446)
//      -> flash_bwd_dkv_sm90_kernel
//   K2 _bwd_dq_kernel (line 278, with _bwd_p_ds at line 243, launched at
//      line 426) -> flash_bwd_dq_sm90_kernel
// under flash_bwd.cu's contract, from the forward's lse and delta =
// rowsum(do * o) (f32, taken by the caller):
//
//   s  = (q . k) * scale                                  f32
//   p  = exp(s - lse), SELECTED to 0 where the key is invalid (past T, past
//        lens, key mask 0, above the causal diagonal, behind the window) or
//        the query is at or past T: a fully masked row has lse ~ -1e30,
//        where exp overflows, and a zero row that TMA filled past T has a
//        zero lse
//   ds = p * (do . v - delta) * scale                     f32
//   dq = sum_k bf16(ds) . k,  dv = sum_q bf16(p)^T . do,  dk = sum_q bf16(ds)^T . q
//
// with every sum in f32: packing ds and p into wgmma's register A fragment
// is exactly the reference's rounding. The two passes stay apart, with no
// atomics, so the gradients are the same bits from run to run.
//
// Design. Both kernels have K1's shape (flash_fwd_sm90.cu): three
// warpgroups, warpgroup 2 a producer that gives its registers away
// (setmaxnreg) and has one thread issue TMA loads, warpgroups 0 and 1
// consumers of 64 rows each; every tile a 3-D TMA box of (64 columns, rows,
// 1) over (D, T, B*H) with the 128-byte swizzle, so rows past T arrive as
// zeros; ring slots guarded by full/empty mbarriers waited on with phase
// parity (a wait traps after 2^34 cycles instead of hanging the card).
//
//   dK/dV: one CTA per (b*h, 128 keys), the key tiles that see the most
//          queries first. K and V are loaded once; the ring carries
//          (Q, dO) tiles of 64 queries by TMA, and their lse and delta,
//          which the producer's first warp copies with plain loads (a 1-D
//          TMA box of them failed on the card where its start was off a
//          16-byte boundary, and a head's statistics start at b*h * T
//          floats). Per query tile a consumer (64 keys) runs
//            S^T = K.Q^T, dP^T = V.dO^T   wgmma, both operands K-major in
//                                          shared memory, committed as two
//                                          groups;
//            p^T, ds^T                    in registers, p^T while dP^T still
//                                          runs; lse and delta read per
//                                          accumulator column from the
//                                          slot's shared copy;
//            dV += bf16(P^T).dO, dK += bf16(dS^T).Q
//                                          wgmma with A from registers and
//                                          dO, Q the same ring slot read as
//                                          MN-major B operands (the
//                                          transpose-B immediate): each slot
//                                          serves two products under two
//                                          descriptors.
//          Under causal the query tiles run from the diagonal; the window
//          ends them early; a key tile wholly past its length visits none
//          and writes dk = dv = 0 exactly.
//   dQ:    one CTA per (b*h, 128 queries), the query tiles that see the
//          most keys first. Q, dO are loaded once and each row's lse and
//          delta read into registers; the ring carries (K, V) tiles of 64
//          keys. Per key tile a consumer (64 queries) runs S = Q.K^T and
//          dP = dO.V^T (K-major, two groups), p while dP runs and then ds
//          in registers, dQ += bf16(dS).K with K read as an MN-major B
//          operand.
//
// Masking as K1: each tile is classified once per consumer warpgroup. A
// tile whose every (query, key) pair is valid (inside the length and T, at
// or below the diagonal, inside the window, no key mask, positive scale)
// runs with no per-element test; a tile with no valid pair for the
// warpgroup skips its products; the rest test each element against its
// row's interval of valid columns (one interval per row: the length or T,
// the diagonal, the window), with the key mask's bits read before the
// products, and no branch.
//
// Bound on an H100 SXM at the training shape (B*H = 128, T = 1024, D = 64,
// bf16, causal, 524,800 pairs per head): dQ does 6*D FLOP per pair (s, dp,
// dq), 25.8 GFLOP, 26 us at the 989 TFLOP/s bf16 peak, against 85 MB of
// bytes (25 us at 3.35 TB/s); dK/dV 8*D FLOP per pair, 34.4 GFLOP, 35 us,
// against 102 MB (30 us). Operations on the tensor cores bound both, and
// the design keeps every product on wgmma fed by TMA with the next tile in
// flight. What stands between it and the bound, by its structure: in a
// consumer warpgroup only p overlaps a product (dP's); ds and the packing
// run between products, so the tensor cores wait through them unless the
// other warpgroup fills the gap (issuing dV's product before ds is formed
// spilled in dK/dV: a thread holds dK, dV, s and dp, 128 floats); the
// 64-wide products (m64n64k16) read both operands from shared memory for S
// and dP; one CTA fills an SM, so a CTA's first loads and its stores are
// not hidden behind another CTA's work. Not done yet: ping-pong between the
// consumer warpgroups, a persistent grid, stores by TMA.

#include "sm90_common.cuh"

// A named namespace (not an anonymous one) keeps the kernels' mangled names,
// which ptxas's report prints, the same from build to build.
namespace dl4j_flash_bwd_sm90 {

constexpr int CONSUMERS = 2 * 128;        // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int WG_ROWS = 64;               // rows a consumer warpgroup owns
constexpr int STAGES = 3;                 // ring depth
constexpr int PRODUCER_REGS = 40;         // setmaxnreg: 128 * 40 +
constexpr int CONSUMER_REGS = 232;        //   256 * 232 = 384 * 168

// dK/dV: 128 keys a CTA, 64 queries a ring tile
template <int D>
struct DkvTile {
  static constexpr int BK = 2 * WG_ROWS;
  static constexpr int BQ = 64;
  static constexpr int CH = D / 64;                    // 64-column boxes a row
  static constexpr int KV_BYTES = BK * D * 2;          // K or V
  static constexpr int QT_BYTES = BQ * D * 2;          // Q or dO in a slot
  static constexpr int STAGE_BYTES = 2 * QT_BYTES;
  static constexpr int STAT_BYTES = BQ * 4;            // lse or delta in a slot
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  // the tiles, the statistics, the barriers, and slack to align the tiles
  // to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int SMEM =
      2 * KV_BYTES + STAGES * (STAGE_BYTES + 2 * STAT_BYTES) + BAR_BYTES + 1024;
};

// dQ: 128 queries a CTA, 64 keys a ring tile
template <int D>
struct DqTile {
  static constexpr int BQ = 2 * WG_ROWS;
  static constexpr int BK = 64;
  static constexpr int CH = D / 64;
  static constexpr int Q_BYTES = BQ * D * 2;           // Q or dO
  static constexpr int KV_BYTES = BK * D * 2;          // K or V in a slot
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES + 1024;
};

// The products A.B^T of a warpgroup's 64 rows of a (rows, D) tile at a_s
// (a_rows rows a box) against the N rows of the tile at b_s (N rows a box),
// both K-major with the 128-byte swizzle: k-step kk is 32 bytes into the
// swizzled rows of box kk / 4. x (N / 2 accumulators) is overwritten.
template <int D, int N>
__device__ __forceinline__ void rows_dot(float (&x)[N / 2], uint32_t a_s, int a_rows,
                                         uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(x, smem_desc(a_s + (kk / 4) * a_rows * ROW_BYTES + col, 16, 1024),
             smem_desc(b_s + (kk / 4) * N * ROW_BYTES + col, 16, 1024), kk > 0);
  }
}

// acc += X.M for X (64 x K) given as register A fragments x[K / 16] and M
// the (K, D) tile at m_s read as an MN-major B operand: k-step j is rows
// 16j..16j+15, two 1024-byte groups of 8 rows; the second 64 columns
// (D = 128) are the next box, K rows on.
template <int D, int K>
__device__ __forceinline__ void frag_times(float (&acc)[D / 2], const uint32_t (&x)[K / 16][4],
                                           uint32_t m_s) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    wgmma_rs(acc, x[j], smem_desc(m_s + j * 16 * ROW_BYTES, K * ROW_BYTES, 1024));
}

// Accumulators of columns 16j..16j+7 and 16j+8..16j+15, rounded to bf16,
// are the A fragment of k-step j.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack_bf16(x[8 * j + 0], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// Rows row0 and row0 + 8 of accumulator acc (64 x D) to a (t_len, D) bf16
// slab at dst; rows at or past t_len are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 2],
                                           int row0, int t_len, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    __nv_bfloat16* out = dst + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// ------------------------------------------------------------ K3: dK, dV
// p^T of one (64 keys x BQ queries) tile in place of s^T. A thread's
// columns are queries q0 + 2t + 8j + e % 2; lse_s is the slot's copy from
// q0. MASKED tests each element against the row's valid columns [lo, hi]
// (offsets from q0 + 2t: the key's length and mask, T, the diagonal, the
// window) and selects p = 0 outside them.
template <int BQ, bool MASKED>
__device__ __forceinline__ void p_cols(float (&s)[BQ / 2], const float* lse_s, float c, int t,
                                       const int (&lo)[2], const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float nl[2] = {-l.x * LOG2E, -l.y * LOG2E};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[4 * j + e], c, nl[e % 2]));
      if (MASKED) {
        const int qr = 8 * j + e % 2;
        p = (qr >= lo[e / 2]) & (qr <= hi[e / 2]) ? p : 0.f;
      }
      s[4 * j + e] = p;
    }
  }
}

// ds^T = p^T (dp^T - delta) scale of the same tile in place of dp^T;
// delta_s is the slot's copy from q0.
template <int BQ>
__device__ __forceinline__ void ds_cols(const float (&p)[BQ / 2], float (&dp)[BQ / 2],
                                        const float* delta_s, float scale, int t) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - (e % 2 ? d.y : d.x)) * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ lens, const int8_t* __restrict__ kmask,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int t_len, int n_bh, float c, float scale, int causal, int window) {
  using TL = DkvTile<D>;
  constexpr int BK = TL::BK;
  constexpr int BQ = TL::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + TL::KV_BYTES;
  const uint32_t q_s = v_s + TL::KV_BYTES;              // slot st: + st * STAGE_BYTES,
                                                        //   dO QT_BYTES after Q
  const uint32_t stat_s = q_s + STAGES * TL::STAGE_BYTES;  // slot st: lse, then delta
  const uint32_t bars = stat_s + STAGES * 2 * TL::STAT_BYTES;  // full[], empty[], kv
  const uint32_t kv_bar = bars + 16 * STAGES;
  float* stats = reinterpret_cast<float*>(smem_raw + (stat_s - raw));

  const int kt = blockIdx.x / n_bh;  // key tile 0 sees the most queries under causal
  const int bh = blockIdx.x % n_bh;
  const int k0 = kt * BK;
  const int lim = min(lens ? lens[bh] : t_len, t_len);
  // query tiles that reach this key tile: none when it is wholly past the
  // length, none above the diagonal, none wholly past its last key's window
  const int qt_begin = causal ? k0 / BQ : 0;
  int qt_end = k0 < lim ? (t_len + BQ - 1) / BQ : qt_begin;
  if (causal && window > 0) qt_end = min(qt_end, (k0 + BK - 1 + window - 1) / BQ + 1);
  const int n_tiles = qt_end - qt_begin;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1 + 32);                 // full: the TMA, each stats lane
      mbar_init(bars + 8 * (STAGES + st), CONSUMERS);   // empty: every consumer
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------- producer
    // the first warp stays: lane 0 issues the TMA loads, and each lane
    // copies two queries' lse and delta into the slot and arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = threadIdx.x - CONSUMERS;
    if (lane >= 32 || n_tiles <= 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * TL::KV_BYTES);
#pragma unroll
      for (int ch = 0; ch < TL::CH; ++ch) {
        tma_load(k_s + ch * BK * ROW_BYTES, &kmap, kv_bar, ch * 64, k0, bh);
        tma_load(v_s + ch * BK * ROW_BYTES, &vmap, kv_bar, ch * 64, k0, bh);
      }
    }
    const size_t base = static_cast<size_t>(bh) * t_len;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) & 1) ^ 1);  // slot free
      const uint32_t full = bars + 8 * st;
      const int q0 = (qt_begin + i) * BQ;
      if (lane == 0) {
        mbar_expect_tx(full, TL::STAGE_BYTES);
        const uint32_t slot = q_s + st * TL::STAGE_BYTES;
#pragma unroll
        for (int ch = 0; ch < TL::CH; ++ch) {
          tma_load(slot + ch * BQ * ROW_BYTES, &qmap, full, ch * 64, q0, bh);
          tma_load(slot + TL::QT_BYTES + ch * BQ * ROW_BYTES, &domap, full, ch * 64, q0,
                   bh);
        }
      }
      // (queries past T get 0: they are masked)
      float* stat = stats + st * 2 * BQ;
#pragma unroll
      for (int e = 0; e < BQ / 32; ++e) {
        const int qi = (BQ / 32) * lane + e;
        const bool live = q0 + qi < t_len;
        stat[qi] = live ? lse[base + q0 + qi] : 0.f;
        stat[BQ + qi] = live ? delta[base + q0 + qi] : 0.f;
      }
      mbar_arrive(full);  // releases this lane's stores to the consumers
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  const int kw0 = k0 + WG_ROWS * wg;         // this warpgroup's first key
  const int krow0 = kw0 + 16 * warp + g;     // this thread's keys: krow0, krow0 + 8
  const int8_t* km = kmask ? kmask + static_cast<size_t>(bh) * t_len : nullptr;
  const uint32_t k_wg = k_s + WG_ROWS * wg * ROW_BYTES;
  const uint32_t v_wg = v_s + WG_ROWS * wg * ROW_BYTES;

  // each key row's valid queries, one interval [lo, hi]: from the key
  // itself under causal, up to T - 1 or the window's end; empty for a key
  // past the length or masked out
  int lo_abs[2], hi_abs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = krow0 + 8 * r;
    const bool ok = kp < lim && (km == nullptr || km[kp] != 0);
    lo_abs[r] = causal ? kp : 0;
    hi_abs[r] = !ok ? -1 : window > 0 ? min(t_len - 1, kp + window - 1) : t_len - 1;
  }

  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    const int q0 = (qt_begin + i) * BQ;
    // no valid pair for this warpgroup: its keys are past the length, the
    // tile is above their diagonal, or wholly behind their window
    const bool skip = kw0 >= lim || (causal && q0 + BQ - 1 < kw0)
                      || (window > 0 && q0 - (kw0 + WG_ROWS - 1) >= window);
    if (!skip) {
      // p^T is formed while dP^T runs (issuing dV's product before ds^T is
      // formed as well needs more registers than a thread has: it spilled)
      const uint32_t q_st = q_s + st * TL::STAGE_BYTES;
      const uint32_t do_st = q_st + TL::QT_BYTES;
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      rows_dot<D, BQ>(s, k_wg, BK, q_st);     // S^T = K.Q^T
      wgmma_commit();
      rows_dot<D, BQ>(dp, v_wg, BK, do_st);   // dP^T = V.dO^T
      wgmma_commit();

      // (a scale <= 0 runs every tile masked, as K1 does)
      const bool interior = c > 0.f && km == nullptr && kw0 + WG_ROWS <= lim
                            && q0 + BQ <= t_len && (!causal || q0 >= kw0 + WG_ROWS - 1)
                            && (window <= 0 || q0 + BQ - 1 - kw0 < window);
      const float* lse_st = stats + st * 2 * BQ;
      const int qb = q0 + 2 * t;
      const int lo[2] = {lo_abs[0] - qb, lo_abs[1] - qb};
      const int hi[2] = {hi_abs[0] - qb, hi_abs[1] - qb};
      wgmma_wait<1>();
      fence_regs(s);
      if (interior)
        p_cols<BQ, false>(s, lse_st, c, t, lo, hi);
      else
        p_cols<BQ, true>(s, lse_st, c, t, lo, hi);
      wgmma_wait<0>();
      fence_regs(dp);
      ds_cols<BQ>(s, dp, lse_st + BQ, scale, t);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_frags<BQ>(pa, s);
      pack_frags<BQ>(da, dp);

      wgmma_fence();
      frag_times<D, BQ>(dvacc, pa, do_st);    // dV += P^T.dO
      frag_times<D, BQ>(dkacc, da, q_st);     // dK += dS^T.Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dvacc);
      fence_regs(dkacc);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(bars + 8 * (STAGES + st));  // this thread is done with the slot
  }

  const size_t base = static_cast<size_t>(bh) * t_len * D;
  store_rows<D>(dk + base, dkacc, krow0, t_len, t);
  store_rows<D>(dv + base, dvacc, krow0, t_len, t);
}

// --------------------------------------------------------------- K2: dQ
// p of one (64 queries x BK keys) tile in place of s. A thread's rows are
// row0 and row0 + 8, with nl2 = -lse * log2(e); its keys k0 + 2t + 8j +
// e % 2. MASKED tests each element against the row's valid keys [lo, hi]
// (offsets from k0 + 2t: the length, the diagonal, the window; empty past
// T) and the key mask's bits, and selects p = 0 outside them.
template <int BK, bool MASKED>
__device__ __forceinline__ void p_rows(float (&s)[BK / 2], const float (&nl2)[2], float c,
                                       const int (&lo)[2], const int (&hi)[2],
                                       uint32_t kbits) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e / 2;
      float p = ex2(fmaf(s[4 * j + e], c, nl2[r]));
      if (MASKED) {
        const int kr = 8 * j + e % 2;
        const bool ok = (kr >= lo[r]) & (kr <= hi[r])
                        & (((kbits >> (2 * j + e % 2)) & 1u) != 0);
        p = ok ? p : 0.f;
      }
      s[4 * j + e] = p;
    }
  }
}

// ds = p (dp - delta) scale of the same tile, with dl = delta of the
// thread's two rows, packed to bf16 as the A fragments da.
template <int BK>
__device__ __forceinline__ void ds_rows(const float (&p)[BK / 2], float (&dp)[BK / 2],
                                        uint32_t (&da)[BK / 16][4], const float (&dl)[2],
                                        float scale) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) dp[i] = p[i] * (dp[i] - dl[i % 4 / 2]) * scale;
  pack_frags<BK>(da, dp);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ lens, const int8_t* __restrict__ kmask,
                         __nv_bfloat16* __restrict__ dq, int t_len, int n_bh, int nq, float c,
                         float scale, int causal, int window) {
  using TL = DqTile<D>;
  constexpr int BQ = TL::BQ;
  constexpr int BK = TL::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + TL::Q_BYTES;
  const uint32_t kv_s = do_s + TL::Q_BYTES;               // slot st: + st * STAGE_BYTES,
                                                          //   V KV_BYTES after K
  const uint32_t bars = kv_s + STAGES * TL::STAGE_BYTES;  // full[], empty[], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int bh = blockIdx.x % n_bh;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;  // heaviest first
  const int lim = min(lens ? lens[bh] : t_len, t_len);
  int kt_begin, kt_end;
  key_tile_range<BQ, BK>(q0, lim, causal, window, &kt_begin, &kt_end);
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (STAGES + st), CONSUMERS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != CONSUMERS || n_tiles <= 0) return;
    mbar_expect_tx(q_bar, 2 * TL::Q_BYTES);
#pragma unroll
    for (int ch = 0; ch < TL::CH; ++ch) {
      tma_load(q_s + ch * BQ * ROW_BYTES, &qmap, q_bar, ch * 64, q0, bh);
      tma_load(do_s + ch * BQ * ROW_BYTES, &domap, q_bar, ch * 64, q0, bh);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) & 1) ^ 1);  // slot free
      const uint32_t full = bars + 8 * st;
      mbar_expect_tx(full, TL::STAGE_BYTES);
      const int k0 = (kt_begin + i) * BK;
      const uint32_t slot = kv_s + st * TL::STAGE_BYTES;
#pragma unroll
      for (int ch = 0; ch < TL::CH; ++ch) {
        tma_load(slot + ch * BK * ROW_BYTES, &kmap, full, ch * 64, k0, bh);
        tma_load(slot + TL::KV_BYTES + ch * BK * ROW_BYTES, &vmap, full, ch * 64, k0, bh);
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
  const int wr0 = q0 + WG_ROWS * wg;          // this warpgroup's first row
  const int row0 = wr0 + 16 * warp + g;       // this thread's rows: row0, row0 + 8
  const int8_t* km = kmask ? kmask + static_cast<size_t>(bh) * t_len : nullptr;
  const uint32_t q_wg = q_s + WG_ROWS * wg * ROW_BYTES;
  const uint32_t do_wg = do_s + WG_ROWS * wg * ROW_BYTES;
  const size_t base = static_cast<size_t>(bh) * t_len;

  float nl2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    nl2[r] = row < t_len ? -lse[base + row] * LOG2E : 0.f;
    dl[r] = row < t_len ? delta[base + row] : 0.f;
  }
  float dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    const int k0 = (kt_begin + i) * BK;
    // no valid pair for this warpgroup: its rows are past T, the tile is
    // above their diagonal, or wholly behind their window
    const bool skip = wr0 >= t_len || (causal && k0 > wr0 + WG_ROWS - 1)
                      || (window > 0 && wr0 - (k0 + BK - 1) >= window);
    if (!skip) {
      // the key mask is read before the products, while few registers are live
      const uint32_t kbits = km != nullptr ? key_bits<BK>(km, k0 + 2 * t, lim) : ~0u;
      const uint32_t k_st = kv_s + st * TL::STAGE_BYTES;
      const uint32_t v_st = k_st + TL::KV_BYTES;
      // p is formed while dP runs
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      rows_dot<D, BK>(s, q_wg, BQ, k_st);     // S = Q.K^T
      wgmma_commit();
      rows_dot<D, BK>(dp, do_wg, BQ, v_st);   // dP = dO.V^T
      wgmma_commit();

      // (a scale <= 0 runs every tile masked, as K1 does)
      const bool interior = c > 0.f && km == nullptr && k0 + BK <= lim
                            && wr0 + WG_ROWS <= t_len
                            && (!causal || k0 + BK - 1 <= wr0)
                            && (window <= 0 || wr0 + WG_ROWS - 1 - k0 < window);
      const int kb = k0 + 2 * t;
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        hi[r] = row >= t_len ? -1 : (causal ? min(lim - 1, row) : lim - 1) - kb;
        lo[r] = window > 0 ? row - window + 1 - kb : -BK;
      }
      wgmma_wait<1>();
      fence_regs(s);
      if (interior)
        p_rows<BK, false>(s, nl2, c, lo, hi, kbits);
      else
        p_rows<BK, true>(s, nl2, c, lo, hi, kbits);
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[BK / 16][4];
      ds_rows<BK>(s, dp, da, dl, scale);

      wgmma_fence();
      frag_times<D, BK>(dqacc, da, k_st);      // dQ += dS.K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqacc);
      fence_regs(da);
    }
    mbar_arrive(bars + 8 * (STAGES + st));
  }
  store_rows<D>(dq + base * D, dqacc, row0, t_len, t);
}

// ------------------------------------------------------------------- host
template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* lens,
                       const void* kmask, void* dk, void* dv, int bh, int t_len, float scale,
                       int causal, int window, cudaStream_t stream) {
  using TL = DkvTile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_map(encode, &qmap, q, bh, t_len, D, TL::BQ)
      || !encode_map(encode, &kmap, k, bh, t_len, D, TL::BK)
      || !encode_map(encode, &vmap, v, bh, t_len, D, TL::BK)
      || !encode_map(encode, &domap, dout, bh, t_len, D, TL::BQ))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  static std::atomic<uint64_t> smem_set{0};  // per head dim
  const cudaError_t e = allow_smem_once(kernel, TL::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  const int nk = (t_len + TL::BK - 1) / TL::BK;
  kernel<<<static_cast<unsigned>(bh) * nk, THREADS, TL::SMEM, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(lens),
      static_cast<const int8_t*>(kmask), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t_len, bh, scale * LOG2E, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* lens, const void* kmask,
                      void* dq, int bh, int t_len, float scale, int causal, int window,
                      cudaStream_t stream) {
  using TL = DqTile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_map(encode, &qmap, q, bh, t_len, D, TL::BQ)
      || !encode_map(encode, &kmap, k, bh, t_len, D, TL::BK)
      || !encode_map(encode, &vmap, v, bh, t_len, D, TL::BK)
      || !encode_map(encode, &domap, dout, bh, t_len, D, TL::BQ))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  static std::atomic<uint64_t> smem_set{0};  // per head dim
  const cudaError_t e = allow_smem_once(kernel, TL::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  const int nq = (t_len + TL::BQ - 1) / TL::BQ;
  kernel<<<static_cast<unsigned>(bh) * nq, THREADS, TL::SMEM, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(lens),
      static_cast<const int8_t*>(kmask), static_cast<__nv_bfloat16*>(dq), t_len, bh, nq,
      scale * LOG2E, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace dl4j_flash_bwd_sm90

extern "C" {

// The arguments of dl4j_flash_bwd_dq and dl4j_flash_bwd_dkv (flash_bwd.cu):
// q, k, v, dout, dq/dk/dv (bh, t_len, d) contiguous bf16, 16-byte aligned;
// lse, delta (bh, t_len) f32; lens (bh,) int32 or null; kmask (bh, t_len)
// int8 or null; window <= 0 means none. Take bf16 (is_bf16 = 1) at d = 64
// only, else return cudaErrorInvalidValue. Each returns a cudaError_t.
int dl4j_flash_bwd_sm90_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* lens,
                           const void* kmask, void* dq, int bh, int t_len, int d, int is_bf16,
                           float scale, int causal, int window, void* stream) {
  using namespace dl4j_flash_bwd_sm90;
  if (!is_bf16 || d != 64) return cudaErrorInvalidValue;
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_dq<64>(q, k, v, dout, lse, delta, lens, kmask, dq, bh, t_len, scale, causal,
                       window, s);
}

int dl4j_flash_bwd_sm90_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* lens,
                            const void* kmask, void* dk, void* dv, int bh, int t_len, int d,
                            int is_bf16, float scale, int causal, int window, void* stream) {
  using namespace dl4j_flash_bwd_sm90;
  if (!is_bf16 || d != 64) return cudaErrorInvalidValue;
  if (bh <= 0 || t_len <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_dkv<64>(q, k, v, dout, lse, delta, lens, kmask, dk, dv, bh, t_len, scale,
                        causal, window, s);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
