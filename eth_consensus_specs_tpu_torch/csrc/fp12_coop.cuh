// The cooperative round engine: K11 (miller.cu) and K12 (final_exp.cu) run
// their Fq12 arithmetic on it, K17 (g1_msm.cu) its G1 formulas and K14
// (h2c.cu) its G2 formulas (curve_coop.cuh). A group of threads keeps its
// values in shared memory, one Fq element a slot of 12 words laid out
// word-major (word k of slot j at mem[k * stride + j]), so that 32 lanes on
// 32 neighbouring slots touch 32 banks; element-major rows of 12 words would
// put them on 8.
//
// Every operation is a program of rounds (ops/fq12_coop.py builds them from
// the formulas into fp12_coop_ops.cuh, which the build generates), in three
// families (CoopFam<F>: the Fq12 tower, G1 and G2), each with its own
// constants, table and widest round. The group's barrier separates rounds: a
// named barrier (bar.sync id, n), so that groups of one block never wait on
// each other, or __syncwarp for a group of one warp. A round of family F
// holds at most CoopFam<F>::kMaxWidth instructions, and a group runs them
// all at once: coop_group_fits<F> states the room a kernel's group must have.
// * a product round: instruction i is one Montgomery product L * R, L and R
//   small signed sums of slots (Karatsuba's operand sums with xi and v
//   folded in), on 1, 2 or 4 lanes (with more than one, half the lanes sum
//   L and half R): an Fq12 product is one round of 54, a
//   complex squaring 36, a Granger-Scott squaring 18, a line 48, a
//   Frobenius map 18 or 12;
// * an add round: instruction i writes one signed sum of slots (Karatsuba's
//   recombinations) from one thread: columns of 64-bit sums, resolved by
//   carry chains, less the quotient by p estimated from the top words. Sums
//   are lazy, in [0, 3p); a product takes such operands and gives a
//   canonical value, so whatever leaves the tower leaves through a product;
// * an inverse round: one Fq inverse on the product's lanes, a Fermat power by
//   p - 2 in 4-bit windows (380 squarings, 91 products) over the table of
//   x^1..x^15 that the rounds before it fill, the lanes' values in registers.
//
// A product on one lane is fp_mul (bls_fp.cuh, in registers). On L = 2 or 4
// lanes it is the same CIOS in carry-save form: lane q keeps positions
// [qW, qW + W) (W = 12 / L) of the running sum and two carry words a
// position, so a row needs no carry chain across lanes; the row's quotient m
// comes from lane 0 and the shifted low word from the lane above by
// __shfl_sync; after the 12 rows every lane gathers the three vectors and
// resolves them. K11 takes one lane (kMlLanes: at a block's 129 pairs, two
// or four lanes cost more in throughput than they save in latency), K12 four
// (kFeLanes: one chain, where the split also shortens the inverse's 471
// products); the check entry (fq12_coop.cu) runs 1 and 4, so that the two
// splits can be timed.
//
// Region bases of one op: X, Y, Z inputs, O output (O may be X: in place),
// S the group's constants, power table and scratch. Values are in Montgomery
// form with R = 2^384, under 3p.
#pragma once
#include "bls_fp.cuh"
#include "fp12_coop_ops.cuh"

// a group of ``threads`` threads, ``lanes`` a product, runs every round of
// family F whole: threads / lanes products and threads sums at once
template <int F>
__host__ __device__ constexpr bool coop_group_fits(int threads, int lanes) {
  return threads / lanes >= CoopFam<F>::kMaxWidth && threads % 32 == 0;
}

template <int F>
__device__ __forceinline__ const uint16_t* coop_table_src() {
  if constexpr (F == kFamFq12) return COOP_TABLE;
  else if constexpr (F == kFamG1) return COOP_TABLE_G1;
  else return COOP_TABLE_G2;
}

template <int F>
__device__ __forceinline__ uint32_t coop_op(int op, int k) {
  if constexpr (F == kFamFq12) return COOP_OPS[op][k];
  else if constexpr (F == kFamG1) return COOP_OPS_G1[op][k];
  else return COOP_OPS_G2[op][k];
}

template <int F>
__device__ __forceinline__ uint32_t coop_const_word(int i) {
  if constexpr (F == kFamFq12) return COOP_CONST_WORDS[i];
  else if constexpr (F == kFamG1) return COOP_CONST_WORDS_G1[i];
  else return COOP_CONST_WORDS_G2[i];
}

struct Coop {
  uint32_t* mem;        // the block's slot words
  int stride;           // slots in the block
  int s;                // this group's S base slot
  int tid;              // thread in the group
  int bar;              // the group's named barrier (1..15)
  int nthreads;         // threads in the group, a multiple of 32
  const uint16_t* tab;  // the family's program table, staged in shared memory
};

// the block's copy of family F's program table (CoopFam<F>::kTableWords u32
// words of shared memory at ``tab``): every thread of the block calls it,
// then the block's barrier
template <int F = kFamFq12>
__device__ __forceinline__ void coop_stage_table(uint32_t* tab) {
  uint16_t* t = reinterpret_cast<uint16_t*>(tab);
  const uint16_t* src = coop_table_src<F>();
  for (int i = threadIdx.x; i < 2 * CoopFam<F>::kTableWords; i += blockDim.x) t[i] = src[i];
  __syncthreads();
}

struct CoopBases {
  int x, y, z, o, s;  // slot bases of the regions X, Y, Z, O, S
};

__device__ __forceinline__ void coop_sync(const Coop g) {
  if (g.nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g.bar), "r"(g.nthreads) : "memory");
  }
}

__device__ __forceinline__ int coop_slot(uint32_t term, const CoopBases& b) {
  const uint32_t region = (term >> 9) & 7;
  const int base = region == 0 ? b.x : region == 1 ? b.y : region == 2 ? b.z : region == 3 ? b.o : b.s;
  return base + static_cast<int>(term & 0x1FFu);
}

__device__ __forceinline__ void coop_read(fp& r, const Coop g, int slot) {
#pragma unroll
  for (int k = 0; k < 12; ++k) r.v[k] = g.mem[k * g.stride + slot];
}

__device__ __forceinline__ void coop_write(const Coop g, int slot, const fp& a) {
#pragma unroll
  for (int k = 0; k < 12; ++k) g.mem[k * g.stride + slot] = a.v[k];
}

// r = a + b and r = a - b over 13 words, one carry chain each (the chain
// needs the asm statements back to back; volatile keeps their order)
__device__ __forceinline__ void coop_add13(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int k = 1; k < 12; ++k)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r[k]) : "r"(a[k]), "r"(b[k]));
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r[12]) : "r"(a[12]), "r"(b[12]));
}

__device__ __forceinline__ void coop_sub13(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int k = 1; k < 12; ++k)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r[k]) : "r"(a[k]), "r"(b[k]));
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r[12]) : "r"(a[12]), "r"(b[12]));
}

// 64-bit columns (word k of column k plus its carry into word k + 1) -> a
// 13-word number
__device__ __forceinline__ void coop_columns(uint32_t* r, const uint64_t* col) {
  uint32_t lo[13], hi[13];
  lo[12] = hi[0] = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    lo[k] = static_cast<uint32_t>(col[k]);
    hi[k + 1] = static_cast<uint32_t>(col[k] >> 32);
  }
  coop_add13(r, lo, hi);
}

// v (13 words) under 2^389 -> a value congruent mod p in [0, 3p), in v's
// low 12 words. The quotient by p is estimated from v's top 64 bits against
// p's top word plus one, never above it and at most 2 below.
__device__ __forceinline__ void coop_reduce(uint32_t* v) {
  const uint64_t top = (static_cast<uint64_t>(v[12]) << 32) | v[11];
  const uint32_t q = static_cast<uint32_t>(__umul64hi(top, kCoopTopInv));
  uint64_t qp[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) qp[k] = static_cast<uint64_t>(q) * FP_P[k];
  uint32_t t[13];
  coop_columns(t, qp);
  coop_sub13(v, v, t);
}

// r = the signed sum of ``n`` terms at ``terms`` (weight under 64), a value in
// [0, 3p) for slots in [0, 3p): sums are lazy, and every product takes
// operands under 3p and gives a canonical value
__device__ __forceinline__ void coop_sum(fp& r, const Coop g, const uint16_t* terms, int n,
                                         const CoopBases& b) {
  const uint32_t first = terms[0];
  if (n == 1 && (static_cast<int16_t>(first) >> 12) == 1) {
    coop_read(r, g, coop_slot(first, b));
    return;
  }
  uint64_t pos[12], neg[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) pos[k] = neg[k] = 0;
  uint32_t neg_weight = 0;
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const uint32_t term = terms[t];
    const int c = static_cast<int16_t>(term) >> 12;
    const int slot = coop_slot(term, b);
    const uint32_t cp = c > 0 ? c : 0, cn = c < 0 ? -c : 0;
    neg_weight += cn;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const uint32_t x = g.mem[k * g.stride + slot];
      pos[k] += static_cast<uint64_t>(x) * cp;
      neg[k] += static_cast<uint64_t>(x) * cn;
    }
  }
  // sum = pos + neg_weight * 3p - neg, in [0, 189 p)
#pragma unroll
  for (int k = 0; k < 12; ++k) pos[k] += static_cast<uint64_t>(neg_weight * 3u) * FP_P[k];
  uint32_t v[13], w[13];
  coop_columns(v, pos);
  coop_columns(w, neg);
  coop_sub13(v, v, w);
  coop_reduce(v);
#pragma unroll
  for (int k = 0; k < 12; ++k) r.v[k] = v[k];
}

// r = a * b / R mod p, canonical, for a, b under 3p on L lanes (every lane
// passes the same a, b and receives r): the sum stays under 9p^2/R + p < 2p.
// ``lane`` is the lane in the L, ``mask`` the L lanes' warp mask.
template <int L>
__device__ __forceinline__ void coop_mul(fp& r, const fp& a, const fp& b, int lane, unsigned mask) {
  if constexpr (L == 1) {
    fp_mul(r, a, b);
  } else {
    constexpr int W = 12 / L;
    uint32_t aw[W], pw[W], t[W], ca[W], cb[W];
#pragma unroll
    for (int w = 0; w < W; ++w) aw[w] = pw[w] = t[w] = ca[w] = cb[w] = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if (k / W == lane) {
        aw[k % W] = a.v[k];
        pw[k % W] = FP_P[k];
      }
    }
    // the running sum is sum_j (t_j + ca_j + cb_j) 2^(32 j); each row adds
    // a * b_i + m p and drops the low word, whose carries stay in place
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const uint32_t bi = b.v[i];
      uint64_t s1[W];
#pragma unroll
      for (int w = 0; w < W; ++w) s1[w] = static_cast<uint64_t>(aw[w]) * bi + t[w] + ca[w];
      const uint32_t m0 = (static_cast<uint32_t>(s1[0]) + cb[0]) * FP_NP;
      const uint32_t m = __shfl_sync(mask, m0, 0, L);
      uint32_t lo[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint64_t s2 = static_cast<uint64_t>(m) * pw[w] + static_cast<uint32_t>(s1[w]) + cb[w];
        lo[w] = static_cast<uint32_t>(s2);
        ca[w] = static_cast<uint32_t>(s1[w] >> 32);
        cb[w] = static_cast<uint32_t>(s2 >> 32);
      }
      const uint32_t up = __shfl_down_sync(mask, lo[0], 1, L);
#pragma unroll
      for (int w = 0; w + 1 < W; ++w) t[w] = lo[w + 1];
      t[W - 1] = lane == L - 1 ? 0u : up;
    }
    uint32_t v[12];
    uint64_t c = 0;
#pragma unroll
    for (int q = 0; q < L; ++q) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint64_t s = static_cast<uint64_t>(__shfl_sync(mask, t[w], q, L)) +
                           __shfl_sync(mask, ca[w], q, L) + __shfl_sync(mask, cb[w], q, L) + c;
        v[q * W + w] = static_cast<uint32_t>(s);
        c = s >> 32;
      }
    }
    fp_reduce(r, v, static_cast<uint32_t>(c));  // the sum is under 2p
  }
}

// lane q writes words [qW, qW + W) of r to ``slot``
template <int L>
__device__ __forceinline__ void coop_write_lanes(const Coop g, int slot, const fp& r, int lane) {
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    if (k / (12 / L) == lane) g.mem[k * g.stride + slot] = r.v[k];
  }
}

// dest = x^(p-2), x = the table's x^1, by 4-bit windows from the top: the
// top window is bit 380 alone (x itself), then 95 windows of 4 bits
template <int L, int F>
__device__ void coop_inverse(const Coop g, int dest, const CoopBases& b, int lane, unsigned mask) {
  const int tab = b.s + CoopFam<F>::kTable;
  fp acc, t;
  coop_read(acc, g, tab);
  for (int i = 94; i >= 0; --i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) coop_mul<L>(acc, acc, acc, lane, mask);
    const int w = (FP_PM2[i >> 3] >> ((i & 7) * 4)) & 15;
    if (w) {
      coop_read(t, g, tab + w - 1);
      coop_mul<L>(acc, acc, t, lane, mask);
    }
  }
  coop_write_lanes<L>(g, dest, acc, lane);
}

// Run op ``op`` of family F (fp12_coop_ops.cuh) on the group; every thread
// of the group calls it, and it ends on the group's barrier.
template <int L, int F = kFamFq12>
__device__ __noinline__ void coop_run(const Coop g, int op, int x, int y, int z, int o) {
  const CoopBases b{x, y, z, o, g.s};
  const int r0 = coop_op<F>(op, 0), nr = coop_op<F>(op, 1);
  const int lane = g.tid % L;
  const unsigned mask = L == 1 ? 1u : ((1u << L) - 1u) << ((g.tid & 31) & ~(L - 1));
  for (int r = r0; r < r0 + nr; ++r) {
    const uint32_t rd = g.tab[2 * r] | static_cast<uint32_t>(g.tab[2 * r + 1]) << 16;
    const int first = rd & 0xFFFF, count = (rd >> 16) & 0xFF, kind = rd >> 24;
    if (kind == 1) {
      const int i = g.tid / L;
      if (i < count) {
        const uint16_t* code = g.tab + g.tab[first + i];
        const int nl = code[1], nrt = code[2];
        fp a, c, p;
        if constexpr (L == 1) {
          coop_sum(a, g, code + 3, nl, b);
          coop_sum(c, g, code + 3 + nl, nrt, b);
        } else {  // the lower half of the lanes sums L, the upper half R
          fp mine;
          const bool upper = lane >= L / 2;
          coop_sum(mine, g, code + 3 + (upper ? nl : 0), upper ? nrt : nl, b);
#pragma unroll
          for (int k = 0; k < 12; ++k) {
            a.v[k] = __shfl_sync(mask, mine.v[k], 0, L);
            c.v[k] = __shfl_sync(mask, mine.v[k], L / 2, L);
          }
        }
        coop_mul<L>(p, a, c, lane, mask);
        coop_write_lanes<L>(g, coop_slot(code[0], b), p, lane);
      }
    } else if (kind == 0) {
      if (g.tid < count) {
        const uint16_t* code = g.tab + g.tab[first + g.tid];
        fp a;
        coop_sum(a, g, code + 3, code[1], b);
        coop_write(g, coop_slot(code[0], b), a);
      }
    } else if (g.tid < L) {
      const uint16_t* code = g.tab + g.tab[first];
      coop_inverse<L, F>(g, coop_slot(code[0], b), b, lane, mask);
    }
    coop_sync(g);
  }
}

// the group's constants of family F into S[0..CoopFam<F>::kConsts), then the
// barrier
template <int F = kFamFq12>
__device__ __forceinline__ void coop_init(const Coop g) {
  for (int i = g.tid; i < CoopFam<F>::kConsts * 12; i += g.nthreads)
    g.mem[(i % 12) * g.stride + g.s + i / 12] = coop_const_word<F>(i);
  coop_sync(g);
}

// the Fq12 at ``slot`` set to one (Montgomery form); no barrier
__device__ __forceinline__ void coop_set_one(const Coop g, int slot) {
  for (int i = g.tid; i < 144; i += g.nthreads)
    g.mem[(i % 12) * g.stride + slot + i / 12] = i < 12 ? FP_ONE[i] : 0u;
}

// canonical or Montgomery words row-major [12][12] <-> the Fq12 at ``slot``;
// no barrier
__device__ __forceinline__ void coop_load_words(const Coop g, int slot, const uint32_t* w) {
  for (int i = g.tid; i < 144; i += g.nthreads) g.mem[(i % 12) * g.stride + slot + i / 12] = w[i];
}

__device__ __forceinline__ void coop_store_words(const Coop g, int slot, uint32_t* w) {
  for (int i = g.tid; i < 144; i += g.nthreads) w[i] = g.mem[(i % 12) * g.stride + slot + i / 12];
}

// dst = src^x for the negative BLS parameter, src cyclotomic and dst another
// Fq12: Granger-Scott squarings over |x| = 0xd201000000010000, then the
// conjugate
template <int L>
__device__ void coop_powx(const Coop g, int dst, int src) {
  constexpr uint64_t kX = 0xd201000000010000ull;
  coop_run<L>(g, kOp_cyc, src, 0, 0, dst);
  if ((kX >> 62) & 1ull) coop_run<L>(g, kOp_mul, dst, src, 0, dst);
  for (int bit = 61; bit >= 0; --bit) {
    coop_run<L>(g, kOp_cyc, dst, 0, 0, dst);
    if ((kX >> bit) & 1ull) coop_run<L>(g, kOp_mul, dst, src, 0, dst);
  }
  coop_run<L>(g, kOp_conj, dst, 0, 0, dst);
}
