// K13 h2c_map and K14 h2c_finish: hash-to-G2 after the host's hash_to_field
// (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_).
//
// K13 replaces eth_consensus_specs_tpu/ops/h2c_device.py _h2c_map (:307):
// the simplified SWU map on E2' (_map_to_curve_sswu :224 with the Fq2
// square root _fq2_sqrt_batch :164 and the sgn0 fix-up :147), the 3-isogeny
// into Jacobian coordinates (_iso_map_jacobian :270), and the complete add
// of a message's two mapped points (g2_jacobian.g2_add :95). K14 replaces
// _h2c_finish (:333): cofactor clearing (g2_jacobian.py:156-221) and the
// affine conversion (:225).
//
// What bounds them on the H100: neither is throughput. A deneb block hashes
// 128 messages, 256 field elements: a few SMs' worth of threads, each a long
// chain of dependent Fq products (some 600 instructions each). So the
// design keeps each thread's chain short rather than the card busy:
// - K13 maps one field element a thread (two threads a message, a warp a
//   block; the even thread adds the pair through shared memory), on one root
//   pair and one GCD inverse a warp, so that every thread of a warp runs the
//   same two Fq powers:
//   1. x1 = (-B'/A')(1 + 1/tv2) with 1/tv2 = conj(tv2) / N(tv2). The warp's
//      32 norms are inverted together (warp_batch_inverse: prefix and suffix
//      products by shuffles, then one binary extended GCD on plain integers
//      of their product, on lane 0; the hashed message is public, so a
//      variable-time inverse is allowed, as in K14). One GCD a warp beat a
//      GCD a thread (whose steps diverge across the warp) on the card
//      (PERF.md). So x1 stays affine and the isogeny's Jacobian words stay
//      the plain version's.
//   2. s = N(g(x1))^((p+1)/4), one power. g(x1) is a square in Fq2 exactly
//      when N(g(x1)) is one in Fq, which s^2 = N(g(x1)) tells; otherwise s^2
//      = -N(g(x1)) (-1 is not a square). Then the candidate is x2 = tv1 x1
//      with g(x2) = tv1^3 g(x1), and a root of N(g(x2)) = N(Z)^3 N(u)^6
//      N(g(x1)) follows by products, no power: N(Z) c N(u)^3 s with c^2 =
//      -N(Z) (SSWU_NORM_C holds N(Z) c).
//   3. The chosen candidate v = a + b u and its norm root sn give h = (a +
//      sn)/2 (h = a where that is 0: b = 0 and sn = -a) and one more power,
//      t = h^((p-3)/4): if x = t h squares to h, the root is (x, b t / 2)
//      (1/x = t); else t^2 = -1/h and the root of (a - sn)/2 = -b^2/(4h)
//      gives (b t / 2, -h t). The SSWU point does not depend on which root
//      is taken: sgn0(y) = sgn0(u) fixes y's sign.
//   Both powers run 4-bit fixed windows over the table x^0..x^15, their
//   squarings on fp_sqr; the map's products are calls (fp_mul_call,
//   fp_sqr_call), which keeps a window's code in the instruction cache
//   (1.2x faster on the card). The rare branches are carried: tv2 = 0 (u = 0
//   takes it; x1 = B'/(Z A'), whose g is a square) and a candidate in Fq
//   (b = 0, where h may be 0; the test entry fq2_sqrt_launch runs the same
//   root function on such values).
// - sgn0 reads parity of the plain value: u arrives canonical, y leaves the
//   Montgomery form (a product by 1) before its parity is read.
// - K14 runs one point a warp, on the cooperative round engine's G2 family
//   (curve_coop.cuh), kFinishGroups points a block: the cofactor clearing of
//   g2_jac.cuh g2_clear_cofactor in its order (two [|x|] ladders, each runs
//   of doublings as dbl4/dbl1 programs and 5 complete adds; the psi terms;
//   the adds), each doubling three product rounds and each add four, the
//   Fq2 products of a formula side by side in a round; the doublings (7
//   products a round) on four lanes a product, the rest a product a thread.
//   Then the affine point by one Fq inverse of the norm of Z, a binary
//   extended GCD on one thread between the affine step's two programs (the
//   hashed message's point is public: a variable-time inverse is allowed;
//   on the card it beat the engine's 4-bit-window Fermat chain, PERF.md).
//   Z = 0 (an isogeny pole or a cleared cofactor) gives the infinity flag
//   and x = y = 0. The output is canonical affine, so its words are the
//   plain version's whatever the road.
//
// Boundary (u32 words, 12 per Fq element): K13 reads u canonical,
// [B, 2, 2, 12], and writes the Jacobian sums [B, 3, 2, 12] in bls_fp.cuh's
// Montgomery form; K14 reads those and writes canonical affine
// [B, 2, 2, 12] and int32 flags [B]. The constants below are in the
// Montgomery form (the exponents plain); a CPU test recomputes each.
#include "g2_jac.cuh"
#include "curve_coop.cuh"
#include "fp_gcd.cuh"

// SSWU: A', B', Z, -B'/A', B'/(Z A') (Fq2, Montgomery)
__constant__ uint32_t SSWU_C[5][2][12] = {
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x03135242u, 0xe53a0000u, 0xdef80285u, 0x01080c0fu, 0xe340f6bdu, 0xe7889edbu,
      0x26310601u, 0x0b513751u, 0x17c744abu, 0x02d69857u, 0x79ea5467u, 0x1220b4e9u}},
    {{0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu, 0x3db5a66eu, 0x6e1b9440u,
      0xa79473bau, 0x75bf3c53u, 0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu},
     {0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu, 0x3db5a66eu, 0x6e1b9440u,
      0xa79473bau, 0x75bf3c53u, 0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu}},
    {{0xfff9555cu, 0x87ebffffu, 0xda8ffffau, 0x656fffe5u, 0x45d33ad2u, 0x0fd07493u,
      0x066576f4u, 0xd951e663u, 0x41e980d3u, 0xde291a3du, 0x7dfe040du, 0x0815664cu},
     {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u,
      0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u}},
    {{0x55474fb3u, 0x903c5555u, 0xce451105u, 0x5f98cc95u, 0xefe0fadeu, 0x9f8e582eu,
      0xaebbd062u, 0xc68946b6u, 0x0ee6de53u, 0x467a4ad1u, 0x83e23a05u, 0x0e7146f4u},
     {0xaab85af8u, 0x29c2aaaau, 0xe30eeefau, 0xbf133368u, 0x06cffb45u, 0xc7a27a72u,
      0x44c9425cu, 0x9dee04ceu, 0x3464ce83u, 0x04a15ce5u, 0xb59dac95u, 0x0b8fcaf5u}},
    {{0x44414324u, 0xf2d84444u, 0x93a69d00u, 0x2585c283u, 0x5d972c42u, 0x5dd35cd0u,
      0x4ea89b53u, 0xfd963b74u, 0x91c1fa91u, 0x07f5d9fdu, 0x3ce062c4u, 0x127db28au},
     {0x333b3695u, 0x55743333u, 0x590828fcu, 0xeb72b871u, 0xcb4d5da5u, 0x1c186171u,
      0xee956644u, 0x34a33031u, 0x149d16d0u, 0xc971692au, 0xf5de8b82u, 0x168a1e1fu}}};
__constant__ uint32_t FP_INV2[12] = {0x00015554u, 0x18040000u, 0x3ab00001u, 0x85500005u, 0x253c276fu, 0x633cb57cu,
     0x31ebb502u, 0x6e22d1ecu, 0xf2d14ca2u, 0xd3916126u, 0x1a006596u, 0x17fbb857u};
__constant__ uint32_t ISO_K[15][2][12] = {
    {{0x1ce05e62u, 0x47f671c7u, 0x1206393eu, 0x06dd5707u, 0xf3fd71a2u, 0x7c80cd2au,
      0x9e6cd062u, 0x048103eau, 0xc8d037f6u, 0xc54516acu, 0x0920ea41u, 0x13808f55u},
     {0x1ce05e62u, 0x47f671c7u, 0x1206393eu, 0x06dd5707u, 0xf3fd71a2u, 0x7c80cd2au,
      0x9e6cd062u, 0x048103eau, 0xc8d037f6u, 0xc54516acu, 0x0920ea41u, 0x13808f55u}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x554c71d0u, 0x5fe55555u, 0x236aaaa3u, 0x873fffddu, 0xb26ef918u, 0x6a6b4619u,
      0x08874945u, 0x21c28884u, 0x028cabc5u, 0x2836cda7u, 0xa7fd5abdu, 0x0ac73310u}},
    {{0x555971c3u, 0x0a0c5555u, 0x1f9eaaaeu, 0xdb0c0010u, 0x1d797997u, 0xb1fb2f94u,
      0xef416e1cu, 0xd3960742u, 0xc20556f4u, 0xb70040e2u, 0xe581393bu, 0x149d7861u},
     {0xaaa638e8u, 0xaff2aaaau, 0x91b55551u, 0x439fffeeu, 0xd9377c8cu, 0xb535a30cu,
      0x0443a4a2u, 0x90e14442u, 0x814655e2u, 0x941b66d3u, 0x53fead5eu, 0x05639988u}},
    {{0x71c725edu, 0x40aac71cu, 0x7a84e38eu, 0x19095555u, 0x8f41abc3u, 0xd817050au,
      0xc87f6fb1u, 0xd86485d4u, 0xf885d059u, 0x696eb479u, 0x328002d2u, 0x198e1a74u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0xff13ab97u, 0x1f3affffu, 0x1da3ff3eu, 0xf25bfc61u, 0x3819b208u, 0xca3757cbu,
      0x6f8cec18u, 0x3e642736u, 0x6095b089u, 0x03977bc8u, 0x3f39a952u, 0x04f69db1u}},
    {{0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au, 0x4a6e8b59u, 0x6f7ee9ceu,
      0xc0a95bc6u, 0xb10330b7u, 0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u},
     {0xffd8557du, 0x7588ffffu, 0x6e0bffdfu, 0x41f3ff64u, 0xac426acau, 0xf7b1e8d2u,
      0x32dbb6f8u, 0xb3741acdu, 0x482d581fu, 0xe9daf5b9u, 0xba7431b8u, 0x167f53e0u}},
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
      0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0xbdfc77beu, 0x96d8f684u, 0x3b66d0e2u, 0xb530e4f4u, 0x379652fdu, 0x184a88ffu,
      0xfae804e1u, 0x57cb23ecu, 0xada3eba9u, 0x0fd2e39eu, 0x31c5d5c3u, 0x08c8055eu},
     {0xbdfc77beu, 0x96d8f684u, 0x3b66d0e2u, 0xb530e4f4u, 0x379652fdu, 0x184a88ffu,
      0xfae804e1u, 0x57cb23ecu, 0xada3eba9u, 0x0fd2e39eu, 0x31c5d5c3u, 0x08c8055eu}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x1c91b406u, 0xbf0a71c7u, 0x8b7638fdu, 0x4d6d55d2u, 0x5f205aeeu, 0x9d82f98eu,
      0x1d1a18d5u, 0xa27aa27bu, 0xd2938e86u, 0x02c3b2b2u, 0x0b09807fu, 0x0c7d1342u}},
    {{0x55531c74u, 0xd7f95555u, 0x48daaaa8u, 0x21cffff7u, 0x6c9bbe46u, 0x5a9ad186u,
      0x0221d251u, 0x4870a221u, 0xc0a32af1u, 0x4a0db369u, 0x29ff56afu, 0x02b1ccc4u},
     {0xaaac8e37u, 0xe205aaaau, 0x68795556u, 0xfcdc0007u, 0x8a1537ddu, 0x0c96011au,
      0xf163406eu, 0x1c06a963u, 0x82a881e6u, 0x010df44cu, 0x0f808febu, 0x174f4526u}},
    {{0x2f67f35cu, 0xa470bda1u, 0x3327b425u, 0xc0fe38e2u, 0xc6f0678du, 0xc9d3d0f2u,
      0x5b5a982eu, 0x1c55c993u, 0xf0746764u, 0x27f6c0e2u, 0x28aa9054u, 0x117c5e6eu},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0xfa765adfu, 0x0162ffffu, 0x0083fb75u, 0x8f7bea48u, 0x59e93611u, 0x561b3c22u,
      0xa9c875d5u, 0x11e19fc1u, 0x00367660u, 0xca713efcu, 0x41da1151u, 0x03c6a03du},
     {0xfa765adfu, 0x0162ffffu, 0x0083fb75u, 0x8f7bea48u, 0x59e93611u, 0x561b3c22u,
      0xa9c875d5u, 0x11e19fc1u, 0x00367660u, 0xca713efcu, 0x41da1151u, 0x03c6a03du}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0xfd3b02c5u, 0x5db0ffffu, 0x58ebfdbau, 0xd713f523u, 0xa84d161au, 0x5ea60761u,
      0x4ea6c44au, 0xbb2c75a3u, 0x21c1119bu, 0x0ac67359u, 0xbdacfbf6u, 0x0ee3d913u}},
    {{0x003affc5u, 0x66b10000u, 0x64ec0030u, 0xcb1400e7u, 0x6fa5d106u, 0xa73e5eb5u,
      0xa0fe09a9u, 0x8984c913u, 0x78ad7f13u, 0x11e10afbu, 0x3e918f52u, 0x05429d0eu},
     {0xffc4aae6u, 0x534dffffu, 0x4c67ffcfu, 0x5397ff17u, 0x870b251du, 0xbff273ebu,
      0x52870915u, 0xdaf28271u, 0xca9e2dc3u, 0x393a9cbau, 0xfaee5748u, 0x14be74dbu}},
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
      0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}};
__constant__ uint32_t SQRT_EXP[2][12] = {
    {0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u,
     0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au},
    {0xffffeaaau, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u,
     0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au}};

// N(Z) c with c^2 = -N(Z) = -5, c = (-5)^((p+1)/4) (Montgomery), and R^3 mod p
// (plain words: a product by it takes the GCD's plain inverse of x R to x^-1 R)
__constant__ uint32_t SSWU_NORM_C[12] = {0x7c72b3a1u, 0xd5ebd442u, 0x2ddcd3e5u, 0x1cd49652u, 0x81eec7dfu,
     0xbef2fbb7u, 0x7bd484bfu, 0xa7e8879du, 0x147c4f33u, 0x8ae5e5b2u, 0xba7795dau, 0x12c7e800u};
__constant__ uint32_t FP_R3[12] = {0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu,
     0x9a53352au, 0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

constexpr int kMapThreads = 32;    // 16 messages a block, one warp (warp_batch_inverse)
constexpr int kFinishGroups = 4;   // points a block, a warp each
constexpr int kFinishLanes = 4;    // lanes a product of the doublings
constexpr int kG2Pt = CurveFam<kFamG2>::kPoint;
// a point's group: S, P, a, b, t, the sum, a negated point, one add's work,
// the affine words
constexpr int kFinishSlots = CoopFam<kFamG2>::kSlots + 6 * kG2Pt + kG2AddWork + 4;
constexpr int kFinishStride = kFinishSlots * kFinishGroups;
static_assert(coop_op_fits(kProducts_g2_dbl4, kSums_g2_dbl4, 32, kFinishLanes) &&
              coop_op_fits(kProducts_g2_dbl1, kSums_g2_dbl1, 32, kFinishLanes) &&
              coop_op_fits(kProducts_g2_affine_a, kSums_g2_affine_a, 32, 1) &&
              coop_op_fits(kProducts_g2_affine_b, kSums_g2_affine_b, 32, 1) &&
              coop_op_fits(kProducts_g2_add_b1, kSums_g2_add_b1, 32, 1) &&
              coop_op_fits(kProducts_g2_add_a1, kSums_g2_add_a1, 32, 1),
              "a G2 op wider than a warp at its lanes");

// N(v) = v0^2 + v1^2, the norm to Fq
__device__ __forceinline__ void fp2_norm(fp& n, const fp2& v) {
  fp t;
  fp_sqr_call(n, v.c0);
  fp_sqr_call(t, v.c1);
  fp_add(n, n, t);
}

// a^e for e = SQRT_EXP[which]: (p+1)/4 (which 0) or (p-3)/4 (1), 379 bits,
// in 4-bit fixed windows: the table a^0..a^15 (a squaring and 13 products),
// then from the top window (94, bits 376..379) four squarings and, for a
// nonzero digit d, a product by a^d a window
constexpr int kPowTopWindow = 94;
__device__ __noinline__ void fp_pow_sqrt(fp& r, const fp& a, int which) {
  fp tab[16];
  fp_set(tab[0], FP_ONE);
  tab[1] = a;
  fp_sqr_call(tab[2], a);
  for (int k = 3; k < 16; ++k) fp_mul_call(tab[k], tab[k - 1], a);
  fp acc = tab[(SQRT_EXP[which][kPowTopWindow >> 3] >> ((kPowTopWindow & 7) * 4)) & 15u];
  for (int w = kPowTopWindow - 1; w >= 0; --w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) fp_sqr_call(acc, acc);
    const uint32_t d = (SQRT_EXP[which][w >> 3] >> ((w & 7) * 4)) & 15u;
    if (d) fp_mul_call(acc, acc, tab[d]);
  }
  r = acc;
}

// a square root of v = a + b u, a square, from a root sn of N(v): one power
// of h = (a + sn)/2 (see the header)
__device__ __noinline__ void fp2_root_from_norm(fp2& r, const fp2& v, const fp& sn) {
  fp h, t, x, t0, inv2;
  fp_set(inv2, FP_INV2);
  fp_add(h, v.c0, sn);
  fp_mul_call(h, h, inv2);
  if (fp_is_zero(h)) h = v.c0;  // b = 0, sn = -a: (a - sn)/2 = a
  fp_pow_sqrt(t, h, 1);
  fp_mul_call(x, t, h);
  fp_sqr_call(t0, x);
  if (fp_eq(t0, h)) {  // x = sqrt(h), 1/x = t: root (x, b / (2x))
    r.c0 = x;
    fp_mul_call(t0, v.c1, t);
    fp_mul_call(r.c1, t0, inv2);
  } else {  // (a - sn)/2 = -b^2/(4h) is the square: root (b t / 2, -h t)
    fp_mul_call(t0, v.c1, t);
    fp_mul_call(r.c0, t0, inv2);
    fp_mul_call(t0, h, t);
    fp_neg(r.c1, t0);
  }
}

// RFC 9380 sgn0 (m = 2) of a Montgomery value, on its plain value
__device__ __forceinline__ uint32_t fp2_sgn0(const fp2& a) {
  fp one, c0, c1;
  fp_zero(one);
  one.v[0] = 1;
  fp_mul_call(c0, a.c0, one);
  fp_mul_call(c1, a.c1, one);
  return (c0.v[0] & 1u) | (fp_is_zero(c0) & (c1.v[0] & 1u));
}

// g(x) = x^3 + A' x + B'
__device__ __forceinline__ void sswu_g(fp2& r, const fp2& x) {
  fp2 c, t;
  fp2_sqr(t, x);
  fp2_set(c, SSWU_C[0]);
  fp2_add(t, t, c);
  fp2_mul(t, t, x);
  fp2_set(c, SSWU_C[1]);
  fp2_add(r, t, c);
}

__device__ __forceinline__ void fp_shfl(fp& r, const fp& a, int src) {
#pragma unroll
  for (int k = 0; k < 12; ++k) r.v[k] = __shfl_sync(0xffffffffu, a.v[k], src);
}
__device__ __forceinline__ void fp_shfl_up(fp& r, const fp& a, int d) {
#pragma unroll
  for (int k = 0; k < 12; ++k) r.v[k] = __shfl_up_sync(0xffffffffu, a.v[k], d);
}
__device__ __forceinline__ void fp_shfl_down(fp& r, const fp& a, int d) {
#pragma unroll
  for (int k = 0; k < 12; ++k) r.v[k] = __shfl_down_sync(0xffffffffu, a.v[k], d);
}

// every lane's 1/n for the warp's n (Montgomery, none zero; every lane of
// the warp calls it): prefix and suffix products by shuffles (5 rounds
// each), one GCD inverse of the total on lane 0 (its words N R to (N R)^-1,
// then a product by R^3: N^-1 R), then 1/n_i = (prefix_{i-1} suffix_{i+1})
// / total
__device__ __noinline__ void warp_batch_inverse(fp& r, const fp& n) {
  const int lane = threadIdx.x & 31;
  fp pre = n, suf = n, t, inv, ex, sx;
  for (int d = 1; d < 32; d <<= 1) {
    fp_shfl_up(t, pre, d);
    if (lane >= d) fp_mul_call(pre, pre, t);
  }
  for (int d = 1; d < 32; d <<= 1) {
    fp_shfl_down(t, suf, d);
    if (lane + d < 32) fp_mul_call(suf, suf, t);
  }
  fp_shfl(t, pre, 31);
  if (lane == 0) {
    fp r3;
    fp_inv_gcd(inv.v, t.v);
    fp_set(r3, FP_R3);
    fp_mul_call(inv, inv, r3);
  }
  fp_shfl(inv, inv, 0);
  fp_shfl_up(ex, pre, 1);
  fp_shfl_down(sx, suf, 1);
  if (lane == 0) fp_set(ex, FP_ONE);
  if (lane == 31) fp_set(sx, FP_ONE);
  fp_mul_call(r, inv, ex);
  fp_mul_call(r, r, sx);
}

// affine (x', y') on E2' of u (Montgomery), sgn0(u) given, from the prelude
// tv1 = Z u^2, tv1^2, tv2 = tv1^2 + tv1 and 1/N(tv2) (ninv; unused where
// tv2 = 0): the header's steps
__device__ __noinline__ void map_to_curve_sswu(fp2& x, fp2& y, const fp2& u, uint32_t sgn_u,
                                               const fp2& tv1, const fp2& tv1_2, const fp2& tv2,
                                               const fp& ninv) {
  fp2 c, t, gx;
  if (fp2_is_zero(tv2)) {
    fp2_set(x, SSWU_C[4]);  // B' / (Z A')
  } else {
    fp m;
    fp_mul_call(t.c0, tv2.c0, ninv);
    fp_mul_call(m, tv2.c1, ninv);
    fp_neg(t.c1, m);
    fp one;
    fp_set(one, FP_ONE);
    fp_add(t.c0, t.c0, one);
    fp2_set(c, SSWU_C[3]);  // -B' / A'
    fp2_mul(x, c, t);
  }
  sswu_g(gx, x);
  fp n, s, sn;
  fp2_norm(n, gx);
  fp_pow_sqrt(s, n, 0);
  fp_sqr_call(sn, s);
  if (fp_eq(sn, n)) {  // g(x1) is a square
    sn = s;
  } else {  // x2 = tv1 x1, g(x2) = tv1^3 g(x1), its norm root N(Z) c N(u)^3 s
    fp2_mul(t, tv1_2, tv1);
    fp2_mul(gx, t, gx);
    fp2_mul(x, tv1, x);
    fp nu, k;
    fp2_norm(nu, u);
    fp_sqr_call(sn, nu);
    fp_mul_call(sn, sn, nu);
    fp_set(k, SSWU_NORM_C);
    fp_mul_call(sn, sn, k);
    fp_mul_call(sn, sn, s);
  }
  fp2_root_from_norm(y, gx, sn);
  if (fp2_sgn0(y) != sgn_u) fp2_neg(y, y);
}

// sum_i K[first + i] x^i for the n coefficients, Horner
__device__ __forceinline__ void iso_poly(fp2& r, const fp2& x, int first, int n) {
  fp2 c;
  fp2_set(r, ISO_K[first + n - 1]);
  for (int i = n - 2; i >= 0; --i) {
    fp2_mul(r, r, x);
    fp2_set(c, ISO_K[first + i]);
    fp2_add(r, r, c);
  }
}

// the 3-isogeny E2' -> E2 into Jacobian coordinates:
// Z = xd yd, X = xn xd yd^2, Y = y yn xd^3 yd^2 (a pole gives Z = 0)
__device__ __noinline__ void iso_map_jacobian(g2j& r, const fp2& x, const fp2& y) {
  fp2 xn, xd, yn, yd, yd2, t;
  iso_poly(xn, x, 0, 4);
  iso_poly(xd, x, 4, 3);
  iso_poly(yn, x, 7, 4);
  iso_poly(yd, x, 11, 4);
  fp2_mul(r.Z, xd, yd);
  fp2_sqr(yd2, yd);
  fp2_mul(t, xn, xd);
  fp2_mul(r.X, t, yd2);
  fp2_sqr(t, xd);
  fp2_mul(t, t, xd);
  fp2_mul(t, t, yn);
  fp2_mul(t, t, y);
  fp2_mul(r.Y, t, yd2);
}

// canonical words -> Montgomery, and back
__device__ __forceinline__ void fp2_load(fp2& r, const uint32_t* w) {
  fp_load(r.c0, w);
  fp_load(r.c1, w + 12);
}

__device__ __forceinline__ void fp2_store(uint32_t* w, const fp2& a) {
  fp_store(w, a.c0);
  fp_store(w + 12, a.c1);
}

__device__ __forceinline__ uint32_t sgn0_words(const uint32_t* w) {
  uint32_t zero = 0;
  for (int k = 0; k < 12; ++k) zero |= w[k];
  return (w[0] & 1u) | ((zero == 0) & (w[12] & 1u));
}

__global__ __launch_bounds__(kMapThreads) void h2c_map_kernel(
    const uint32_t* __restrict__ u, uint32_t* __restrict__ out, int64_t n) {
  __shared__ g2j pts[kMapThreads];
  const int64_t e = int64_t(blockIdx.x) * kMapThreads + threadIdx.x;  // element 2 m + k
  const bool live = e < 2 * n;
  fp2 uu, x, y, c, t, tv1, tv1_2, tv2;
  fp nrm;  // N(tv2), one where tv2 = 0 and on idle lanes
  fp_set(nrm, FP_ONE);
  if (live) {
    fp2_load(uu, u + e * 24);
    fp2_sqr(t, uu);
    fp2_set(c, SSWU_C[2]);
    fp2_mul(tv1, c, t);
    fp2_sqr(tv1_2, tv1);
    fp2_add(tv2, tv1_2, tv1);
    if (!fp2_is_zero(tv2)) fp2_norm(nrm, tv2);
  }
  fp ninv;
  warp_batch_inverse(ninv, nrm);  // the whole warp, idle lanes on one
  if (live) {
    map_to_curve_sswu(x, y, uu, sgn0_words(u + e * 24), tv1, tv1_2, tv2, ninv);
    iso_map_jacobian(pts[threadIdx.x], x, y);
  }
  __syncthreads();
  if (live && (threadIdx.x & 1) == 0) {
    g2j s;
    g2_add(s, pts[threadIdx.x], pts[threadIdx.x + 1]);
    uint32_t* o = out + (e >> 1) * 72;
    fp2_write(o, s.X);
    fp2_write(o + 24, s.Y);
    fp2_write(o + 48, s.Z);
  }
}

// dest = x^-1 in Montgomery form for x at ``src`` (x R -> x^-1 R), on the
// calling thread alone: the GCD inverse of the words x R (a lazy value under
// 3p), then a product by R^3 (the family's r3 constant)
__device__ void cc_inverse_gcd(const Coop g, int dest, int src) {
  fp x, inv, r3;
  coop_read(x, g, src);
  fp_inv_gcd(inv.v, x.v);
  coop_read(r3, g, g.s + kC_G2_r3);
  fp_mul(inv, inv, r3);
  coop_write(g, dest, inv);
}

// dst = [|x|] src (g2_jac.cuh g2_mul_z): a run of doublings, then an add of
// src, for each set bit below the top one
__device__ void cc_g2_mul_z(const Coop g, int dst, int src, int w) {
  cc_copy(g, dst, src, kG2Pt);
  int run = 0;
  for (int bit = 62; bit >= 0; --bit) {
    ++run;
    if ((kBlsXAbs >> bit) & 1ull) {
      cc_dbl<kFamG2, kFinishLanes>(g, dst, run);
      run = 0;
      cc_add<kFamG2>(g, 1, dst, src, w, dst);
    }
  }
  cc_dbl<kFamG2, kFinishLanes>(g, dst, run);
}

__global__ __launch_bounds__(kFinishGroups * 32) void h2c_finish_kernel(
    const uint32_t* __restrict__ jac, uint32_t* __restrict__ xy, int32_t* __restrict__ inf,
    int64_t n) {
  __shared__ uint32_t mem[12 * kFinishStride];
  __shared__ uint32_t tab[CoopFam<kFamG2>::kTableWords];
  coop_stage_table<kFamG2>(tab);
  const int grp = threadIdx.x / 32;
  const int64_t m = int64_t(blockIdx.x) * kFinishGroups + grp;
  if (m >= n) return;  // a whole warp leaves; the others sync on their own
  const Coop g{mem, kFinishStride, grp * kFinishSlots, static_cast<int>(threadIdx.x % 32), 1 + grp,
               32, reinterpret_cast<const uint16_t*>(tab)};
  const int Pp = g.s + CoopFam<kFamG2>::kSlots, A = Pp + kG2Pt, B = A + kG2Pt, T = B + kG2Pt,
            C = T + kG2Pt, N = C + kG2Pt, W = N + kG2Pt, OUT = W + kG2AddWork;
  coop_init<kFamG2>(g);
  cc_load(g, Pp, jac + m * 72, kG2Pt);
  // [h_eff]P = [z^2]P + [z]P - P - psi([z+1]P) + psi^2(2P), z = |x|
  cc_g2_mul_z(g, A, Pp, W);
  cc_g2_mul_z(g, B, A, W);
  cc_add<kFamG2>(g, 1, A, Pp, W, T);
  coop_run<1, kFamG2>(g, kOp_g2_psi, T, 0, 0, T);
  cc_add<kFamG2>(g, 1, B, A, W, C);
  coop_run<1, kFamG2>(g, kOp_g2_neg, Pp, 0, 0, N);
  cc_add<kFamG2>(g, 1, C, N, W, C);
  coop_run<1, kFamG2>(g, kOp_g2_neg, T, 0, 0, N);
  cc_add<kFamG2>(g, 1, C, N, W, C);
  coop_run<kFinishLanes, kFamG2>(g, kOp_g2_dbl1, Pp, 0, 0, T);
  coop_run<1, kFamG2>(g, kOp_g2_psi, T, 0, 0, T);
  coop_run<1, kFamG2>(g, kOp_g2_psi, T, 0, 0, T);
  cc_add<kFamG2>(g, 1, C, T, W, C);
  coop_run<1, kFamG2>(g, kOp_g2_affine_a, C, 0, W, OUT);
  if (g.tid == 0) cc_inverse_gcd(g, W + kG2AffineInv, W + kG2AffineNorm);
  coop_sync(g);
  coop_run<1, kFamG2>(g, kOp_g2_affine_b, C, 0, W, OUT);
  const bool at_infinity = cc_zero<kFamG2>(g, W);  // the norm's two products z0^2, z1^2
  cc_store(g, xy + m * 48, OUT, 4);
  if (g.tid == 0) inf[m] = at_infinity ? 1 : 0;
}

__global__ void fq2_sqrt_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ root,
                                int32_t* __restrict__ ok, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp2 a, r;
  fp2_load(a, v + i * 24);
  fp nrm, s, t;
  fp2_norm(nrm, a);
  fp_pow_sqrt(s, nrm, 0);
  fp_sqr(t, s);
  const bool good = fp_eq(t, nrm);  // a is a square exactly when its norm is
  if (good) {
    fp2_root_from_norm(r, a, s);
  } else {
    fp2_zero(r);
  }
  ok[i] = good ? 1 : 0;
  fp2_store(root + i * 24, r);
}

// u: u32[n, 2, 2, 12] canonical; out: u32[n, 3, 2, 12] Montgomery.
extern "C" int h2c_map_launch(const void* u, void* out, int64_t n, cudaStream_t stream) {
  if (n < 1 || n > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((2 * n + kMapThreads - 1) / kMapThreads);
  h2c_map_kernel<<<blocks, kMapThreads, 0, stream>>>(static_cast<const uint32_t*>(u),
                                                      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// jac: u32[n, 3, 2, 12] Montgomery; xy: u32[n, 2, 2, 12] canonical; inf: int32[n]
extern "C" int h2c_finish_launch(const void* jac, void* xy, void* inf, int64_t n,
                                 cudaStream_t stream) {
  if (n < 1 || n > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kFinishGroups - 1) / kFinishGroups);
  h2c_finish_kernel<<<blocks, kFinishGroups * 32, 0, stream>>>(
      static_cast<const uint32_t*>(jac), static_cast<uint32_t*>(xy), static_cast<int32_t*>(inf),
      n);
  return static_cast<int>(cudaGetLastError());
}

// v, root: u32[n, 2, 12] canonical; ok: int32[n]. K13's square root alone:
// the norm's power, then fp2_root_from_norm.
extern "C" int fq2_sqrt_launch(const void* v, void* root, void* ok, int64_t n,
                               cudaStream_t stream) {
  if (n < 1 || n > (int64_t(1) << 30)) return static_cast<int>(cudaErrorInvalidValue);
  fq2_sqrt_kernel<<<static_cast<unsigned>((n + 31) / 32), 32, 0, stream>>>(
      static_cast<const uint32_t*>(v), static_cast<uint32_t*>(root), static_cast<int32_t*>(ok), n);
  return static_cast<int>(cudaGetLastError());
}
