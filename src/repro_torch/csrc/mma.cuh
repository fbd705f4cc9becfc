// Tensor-core fragment helpers shared by csrc/attention.cu (K2's
// forward), csrc/attention_bwd.cu, csrc/ssd.cu and csrc/ssd_bwd.cu:
// ldmatrix (and its .trans), mma.sync (m16n8k8 on TF32 operands,
// m16n8k16 on bf16), the split of an fp32 operand into two TF32 ones,
// mma_abt, the product A B^T of two row-major shared tiles, and mma_ab,
// the product A B of register fragments and a row-major shared tile:
// bf16, with to_a_frags, which rounds fp32 accumulators to bf16 A
// fragments, and fp32 in split-TF32, whose A is the accumulator tiles of
// the previous product; frag_a, mma_pairs and mma_acc_a, whose A is an
// fp32 tile split after its load or accumulator values built in
// registers (K4's forward and backward); and mma_atb_scaled, A^T diag(w)
// B of two row-major shared tiles, in both dtypes.
//
// Fragments of m16n8k8, g = lane / 4, t = lane % 4: a (16 x 8, row)
// {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}; b (8 x 8, col) {(k t, n g),
// (k t+4, n g)}; c (16 x 8, fp32) {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)}.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace gfdit {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 16-byte matrices, thread i giving the address of row i % 8 of
// matrix i / 8; register j gets matrix j's row lane/4, 32-bit word lane%4
// (two bf16: columns 2 (lane%4), +1; or one fp32), or with .trans (bf16
// only) its rows 2 (lane%4), +1 of column lane/4.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col).
// Fragments: a {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}; b {(k t, n g),
// (k t+4, n g)}; c {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, each TF32 rounded to nearest (ties away from zero), to
// ~2^-22 of x.  Done as CUTLASS's 3xTF32 does, on the fp32 bits: the
// mma reads the top 19 bits of an operand and drops the rest, so
// bits + 0x1000 (half a TF32 ulp) is x rounded; hi's dropped bits are
// cleared, so that x - hi is exact.  cvt.rna.tf32.f32 computes the same
// for finite x, but sm_90a runs it as a compare, an add and a select or
// mask (for inf and NaN): with it the DIT_IMAGE self-attention backward
// took 1.39 ms on an H100, with the add and the mask here 1.03 (both
// with one k step a sum in mma_ab).  An inf or NaN operand gives a NaN
// lo, so NaN still reaches the output.
struct Tf32Split {
  unsigned hi, lo;
};
__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const unsigned hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi)) + 0x1000u};
}
__device__ __forceinline__ void split_a(unsigned (&hi)[4], unsigned (&lo)[4],
                                        float a0, float a1, float a2,
                                        float a3) {
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Split s = split_tf32(a[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// An A fragment of fp32 words split in place: `a` keeps hi, `lo` gets lo.
__device__ __forceinline__ void split_frag(unsigned (&a)[4],
                                           unsigned (&lo)[4]) {
  split_a(a, lo, __uint_as_float(a[0]), __uint_as_float(a[1]),
          __uint_as_float(a[2]), __uint_as_float(a[3]));
}

// One fp32 product in split-TF32: c += a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4],
                                           Tf32Split b0, Tf32Split b1) {
  mma_tf32(c, alo, b0.hi, b1.hi);
  mma_tf32(c, ahi, b0.lo, b1.lo);
  mma_tf32(c, ahi, b0.hi, b1.hi);
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Fragments, g = lane / 4, t = lane % 4: a {(g, 2t..), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}; b {(k 2t.., n g), (k 2t+8.., n g)};
// c {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8 NT) += A B^T over K = D: A's 16 rows at `a` and B's 8 NT
// rows at `b`, both row-major T in shared memory at pitch P (B read as
// the col operand, untransposed).  One ldmatrix.x4 a k step of 16 bytes
// a row: k = 16 bf16 (one m16n8k16), or 8 fp32 (one m16n8k8 in
// split-TF32, each operand split after its load).
template <int NT, int D, int P, typename T>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* a,
                                        const T* b, int lane) {
  static_assert(NT % 2 == 0, "mma_abt: n tiles in pairs");
  constexpr int E = 16 / sizeof(T);      // elements a 16-byte unit
  const T* pa = a + (lane & 15) * P + (lane >> 4) * E;
  const T* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * P +
                ((lane >> 3) & 1) * E;
#pragma unroll
  for (int ks = 0; ks < D / (2 * E); ++ks) {
    unsigned af[4];
    ldsm4(af, pa + ks * 2 * E);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bfr[4];
        ldsm4(bfr, pb + np * 16 * P + ks * 16);
        mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    } else {
      unsigned alo[4];
      split_frag(af, alo);                 // af keeps the hi parts
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bfr[4];
        ldsm4(bfr, pb + np * 16 * P + ks * 8);
        mma_3xtf32(acc[2 * np], af, alo, split_tf32(__uint_as_float(bfr[0])),
                   split_tf32(__uint_as_float(bfr[1])));
        mma_3xtf32(acc[2 * np + 1], af, alo,
                   split_tf32(__uint_as_float(bfr[2])),
                   split_tf32(__uint_as_float(bfr[3])));
      }
    }
  }
}

using bf16 = __nv_bfloat16;

// Two bf16 (low, high) times (w_lo, w_hi) in fp32, rounded to bf16.
__device__ __forceinline__ unsigned scale_bf16x2(unsigned v, float w_lo,
                                                 float w_hi) {
  __nv_bfloat162 h;
  memcpy(&h, &v, sizeof(h));
  const float2 f = __bfloat1622float2(h);
  return bf16x2_bits(f.x * w_lo, f.y * w_hi);
}

// ldmatrix with .trans (bf16 only): see ldsm4.
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc (16 x 8 NT) += A B over K = 16 KS: A in registers as KS fragments,
// B's 16 KS rows (k) of 8 NT columns (n) at `b`, row-major bf16 in
// shared memory at pitch P (read by ldmatrix.trans).
template <int NT, int KS, int P>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4],
                                       const unsigned (&a)[KS][4],
                                       const bf16* b, int lane) {
  static_assert(NT % 2 == 0, "mma_ab: n tiles in pairs");
  const bf16* pb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * P +
                   (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bfr[4];
      ldsm4_t(bfr, pb + ks * 16 * P + np * 16);
      mma_bf16(acc[2 * np], a[ks], bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], a[ks], bfr[2], bfr[3]);
    }
}

// The accumulators of 16 x 8 NT, rounded to bf16, as the A fragments of
// a product over K = 8 NT: tiles 2m and 2m + 1 make k step m.
template <int NT>
__device__ __forceinline__ void to_a_frags(unsigned (&a)[NT / 2][4],
                                           const float (&c)[NT][4]) {
#pragma unroll
  for (int m = 0; m < NT / 2; ++m) {
    a[m][0] = bf16x2_bits(c[2 * m][0], c[2 * m][1]);
    a[m][1] = bf16x2_bits(c[2 * m][2], c[2 * m][3]);
    a[m][2] = bf16x2_bits(c[2 * m + 1][0], c[2 * m + 1][1]);
    a[m][3] = bf16x2_bits(c[2 * m + 1][2], c[2 * m + 1][3]);
  }
}

// Long sums on the tensor cores: they do not round their fp32 sum to
// nearest (they truncate the aligned addends), so an accumulator carried
// through thousands of mma steps drifts one way: 1.8e-5 rel-L2 on K2's
// dK at 8 heads x 300 queries, over the 1e-5 budget.  So a sum over a
// long k axis takes the products of kSumSteps k steps into a fresh
// accumulator, which the CUDA cores add to the running one, rounding to
// nearest (on an H100, DIT_IMAGE's self-attention backward took 1.03,
// 0.99 and 0.96 ms with 1, 2 and 4 k steps a sum, at ~1.6e-6 rel-L2
// each).
constexpr int kSumSteps = 4;

// acc (16 x 8 NT) += A B over K = 8 KS in split-TF32: A is the KS
// accumulator tiles c of the previous product (16 x 8 fp32 each), B's
// 8 KS rows (k) of 8 NT columns (n) at `b`, row-major fp32 in shared
// memory at pitch P.  The thread's C columns 2t and 2t + 1 serve as A's
// k slots t and t + 4, so no shuffle is needed; B's rows are read in the
// same order, row 2t into b0 and 2t + 1 into b1, by 32-bit loads.  With
// P = 4 (mod 16) words, the rows 2t of one load lie 8 banks apart and the
// 8 columns g fill them: no conflict.
//
// These products sum over the sequence (the forward's O and the
// backward's dQ over the keys, dV and dK over the GQA group's queries):
// thousands of mma steps an element, so the products of kSumSteps k
// steps go to a fresh accumulator, which the CUDA cores add to `acc`.
template <int NT, int KS, int P>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4],
                                       const float (&c)[KS][4],
                                       const float* b, int lane) {
  static_assert(P % 16 == 4, "mma_ab: the pitch of conflict-free row pairs");
  static_assert(KS % kSumSteps == 0, "mma_ab: k steps in whole sums");
  const float* pb = b + 2 * (lane & 3) * P + (lane >> 2);
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += kSumSteps) {
    unsigned ahi[kSumSteps][4], alo[kSumSteps][4];
#pragma unroll
    for (int j = 0; j < kSumSteps; ++j)
      split_a(ahi[j], alo[j], c[k0 + j][0], c[k0 + j][2], c[k0 + j][1],
              c[k0 + j][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSumSteps; ++j) {
        const float* row = pb + (k0 + j) * 8 * P + 8 * n;
        mma_3xtf32(part, ahi[j], alo[j], split_tf32(row[0]),
                   split_tf32(row[P]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

// The A fragment (16 x 8) at k columns k0.. of the 16 rows at `a`, a
// row-major fp32 shared tile at pitch PA, by ldmatrix, split.
template <int PA>
__device__ __forceinline__ void frag_a(unsigned (&hi)[4], unsigned (&lo)[4],
                                       const float* a, int k0, int lane) {
  unsigned r[4];
  ldsm4(r, a + (lane & 15) * PA + (lane >> 4) * 4 + k0);
  split_a(hi, lo, __uint_as_float(r[0]), __uint_as_float(r[1]),
          __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// acc (16 x 8 NT) += A B over one k step of 8, A given as the values of
// the accumulator layout (rows g, g + 8; columns 2t, 2t + 1 serve as k
// slots t, t + 4) and B's rows k0 + 2t (b0) and k0 + 2t + 1 (b1) at `b`
// (already at row k0, column g), row-major fp32 at pitch PB.  With PB =
// 4 (mod 16) words the rows 2t lie 8 banks apart and the 8 columns g fill
// them: no conflict.
template <int NT, int PB>
__device__ __forceinline__ void mma_pairs(float (&acc)[NT][4], float a0,
                                          float a1, float a2, float a3,
                                          const float* b) {
  static_assert(PB % 16 == 4, "mma_pairs: the pitch of row pairs");
  unsigned ahi[4], alo[4];
  split_a(ahi, alo, a0, a2, a1, a3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    mma_3xtf32(acc[n], ahi, alo, split_tf32(b[8 * n]),
               split_tf32(b[PB + 8 * n]));
}

// acc (16 x 8 NT) += M R over the 16 columns of M, given in the
// accumulator layout as two 16 x 8 tiles (m[0]: columns 0-7, m[1]:
// 8-15), and R's 16 rows of 8 NT columns at `r`, row-major T at pitch PR;
// called once a tile, as each is built.  fp32: tile `half` as one k step
// of 8 in split-TF32 (mma_pairs); bf16: after the second, both rounded to
// one A fragment (to_a_frags) for one m16n8k16 step (mma_ab).
template <int NT, int PR, typename T>
__device__ __forceinline__ void mma_acc_a(float (&acc)[NT][4],
                                          const float (&m)[2][4], int half,
                                          const T* r, int lane) {
  if constexpr (std::is_same_v<T, float>) {
    mma_pairs<NT, PR>(acc, m[half][0], m[half][1], m[half][2], m[half][3],
                      r + (8 * half + 2 * (lane & 3)) * PR + (lane >> 2));
  } else if (half == 1) {
    unsigned a[1][4];
    to_a_frags<2>(a, m);
    mma_ab<NT, 1, PR>(acc, a, r, lane);
  }
}

// acc (16 x 8 NT) += A^T diag(w) B over K rows (k): A's K rows of 16
// columns (the product's rows m) at `a` and B's K rows of 8 NT columns at
// `b`, both row-major T in shared memory at pitches PA and PB.  Row k of
// A is scaled by w[k] (fp32, shared) in registers, so A needs no scaled
// or transposed copy.  The SSD's chunk states (K4's forward, w = dt
// exp(cum_last - cum)) and its backward's state gradients (w = exp(cum))
// are this product.
//   * bf16: A by ldmatrix.trans, each row scaled and rounded to bf16
//     once, so a bf16 operand and an fp32 row weight enter the product
//     with one rounding; one m16n8k16 step a 16 rows (mma_ab).
//   * fp32: A from its rows t and t + 4 (PA = 8 (mod 32) words: the 8
//     columns g of the 4 rows t fill the banks), scaled after the load,
//     then split; B's rows t, t + 4 likewise (PB).  Split-TF32 m16n8k8,
//     the products of KS k steps into a fresh accumulator that the CUDA
//     cores add to acc (kSumSteps, or the k steps there are).
template <int NT, int K, int PA, int PB, typename T>
__device__ __forceinline__ void mma_atb_scaled(float (&acc)[NT][4],
                                               const T* a, const float* w,
                                               const T* b, int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    const bf16* pa = a + ((lane & 7) + ((lane >> 4) << 3)) * PA +
                     ((lane >> 3) & 1) * 8;
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      unsigned af[1][4];
      ldsm4_t(af[0], pa + ks * 16 * PA);
      const float* wk = w + 16 * ks + t2;   // rows 2t, 2t + 1 (a0, a1) and
      const float w0 = wk[0], w1 = wk[1];   // 2t + 8, 2t + 9 (a2, a3)
      const float w8 = wk[8], w9 = wk[9];
      af[0][0] = scale_bf16x2(af[0][0], w0, w1);
      af[0][1] = scale_bf16x2(af[0][1], w0, w1);
      af[0][2] = scale_bf16x2(af[0][2], w8, w9);
      af[0][3] = scale_bf16x2(af[0][3], w8, w9);
      mma_ab<NT, 1, PB>(acc, af, b + ks * 16 * PB, lane);
    }
  } else {
    constexpr int KS = K / 8 < kSumSteps ? K / 8 : kSumSteps;
    static_assert(K % (8 * KS) == 0, "mma_atb_scaled: k steps in whole sums");
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8 * KS) {
      unsigned ahi[KS][4], alo[KS][4];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int r = k0 + 8 * j + tq;
        const float* ca = a + r * PA + gq;
        const float e0 = w[r], e4 = w[r + 4];
        split_a(ahi[j], alo[j], ca[0] * e0, ca[8] * e0, ca[4 * PA] * e4,
                ca[4 * PA + 8] * e4);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const float* yb = b + (k0 + 8 * j + tq) * PB + 8 * n + gq;
          mma_3xtf32(part, ahi[j], alo[j], split_tf32(yb[0]),
                     split_tf32(yb[4 * PB]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
      }
    }
  }
}

}  // namespace gfdit
