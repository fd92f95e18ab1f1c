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

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernel uses
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 128;                        // query rows per CTA
constexpr int CONSUMERS = 2 * 128;             // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;       // and the producer warpgroup
constexpr int STAGES = 2;                      // K/V ring depth
constexpr int ROW_BYTES = 128;                 // one swizzled row of a box
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

// ------------------------------------------------------ shared memory, TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of barrier `bar` has completed. A
// wait that lasts about 8 s (2^34 cycles) traps, so a barrier fault fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One box of a 3-D tensor map, at (column c0, row c1, head c2), into
// shared memory at dst; completion is counted on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of registers that an in-flight
// wgmma writes (or reads) across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma_ss: d (+)= A.B with A (64 x 16) and B (16 x N) both read from shared
// memory by descriptor, K-major; scale_d = 0 overwrites d. wgmma_rs: d +=
// A.B with A from registers (the m16n8k16 A fragment, warp w of the
// warpgroup holding rows 16w..16w+15) and B MN-major in shared memory (the
// transpose-B immediate). The accumulator: register 4j + e of a thread
// (lane = 4g + t, warp w) is row 16w + g + 8(e / 2), column 8j + 2t + e % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- kernel
// First and one-past-last key tile the query tile at q0 must visit.
template <int BK>
__device__ __forceinline__ void key_tile_range(int q0, int lim, int causal, int window,
                                               int* begin, int* end) {
  int e = (lim + BK - 1) / BK;
  if (causal) e = min(e, (q0 + BQ - 1) / BK + 1);
  int b = 0;
  if (causal && window > 0) b = max(0, q0 - (window - 1)) / BK;
  *begin = b;
  *end = e;
}

// 2^x by the special-function unit alone (about 2 ulp; subnormal results
// flush to 0, as exp of a masked or far-below-max score should)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// log2(x) by the special-function unit alone (lg2.approx, about 2^-22 abs)
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 and packed, the lower index in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The key mask at a thread's keys kb + 8j + e (e = 0, 1) of a tile, as bit
// 2j + e, loaded without a branch; a key at or past lim reads as masked.
template <int BK>
__device__ __forceinline__ uint32_t key_bits(const int8_t* km, int kb, int lim) {
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kp = kb + 8 * j + e;
      bits |= static_cast<uint32_t>((kp < lim) & (km[max(min(kp, lim - 1), 0)] != 0))
              << (2 * j + e);
    }
  }
  return bits;
}

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
  key_tile_range<BK>(q0, lim, causal, window, &kt_begin, &kt_end);
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
    wgmma_wait_all();
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
    wgmma_wait_all();
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, T, B*H) bf16 tensor map with (64, rows, 1) boxes and the 128-byte
// swizzle; rows past T read as zeros.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int t_len,
                int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t_len) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  // more than 48 KB of dynamic shared memory needs the attribute, set once
  // per head dim and device
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if ((smem_set.load(std::memory_order_relaxed) & bit) == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return e;
    smem_set.fetch_or(bit, std::memory_order_relaxed);
  }
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
