// SHA-256 of one 64-byte message, as device functions shared by the
// sha256, merkle and validator_leaves kernels.
//
// A 64-byte message is one data block plus the constant padding block
// (0x80 delimiter, zeros, bit length 512). The padding block's message
// schedule never changes, so its 64 words are folded into the round
// constants ahead of time (KW_PAD[t] = K[t] + W_pad[t]): the second
// compression runs no schedule at all. Words are big-endian u32 values,
// as in the JAX package (eth_consensus_specs_tpu/ops/sha256.py).
//
// Bound on the H100: integer ALU. A data compression is at least 1,384
// 32-bit instructions (1,024 logic and shifts, 360 additions), a padding
// compression at least 904 (640 and 264): a rotation is one funnel shift,
// a three-input LOP3 folds each sigma's xors, Ch and Maj, and IADD3 adds
// three terms. Logic and shifts issue only on the ALU pipe; additions can
// also go to the FMA pipe (IMAD.IADD), so the ALU pipe's 1,664 instructions
// per message set the floor. Everything lives in registers: the rounds and the
// rolling 16-word schedule window are fully unrolled so every index is a
// compile-time constant.
#pragma once
#include <cstdint>

__constant__ uint32_t SHA_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

// K[t] + W[t] of the constant padding block of a 64-byte message.
__constant__ uint32_t SHA_KW_PAD[64] = {
    0xC28A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF374u, 0x649B69C1u, 0xF0FE4786u,
    0x0FE1EDC6u, 0x240CF254u, 0x4FE9346Fu, 0x6CC984BEu, 0x61B9411Eu, 0x16F988FAu,
    0xF2C65152u, 0xA88E5A6Du, 0xB019FC65u, 0xB9D99EC7u, 0x9A1231C3u, 0xE70EEAA0u,
    0xFDB1232Bu, 0xC7353EB0u, 0x3069BAD5u, 0xCB976D5Fu, 0x5A0F118Fu, 0xDC1EEEFDu,
    0x0A35B689u, 0xDE0B7A04u, 0x58F4CA9Du, 0xE15D5B16u, 0x007F3E86u, 0x37088980u,
    0xA507EA32u, 0x6FAB9537u, 0x17406110u, 0x0D8CD6F1u, 0xCDAA3B6Du, 0xC0BBBE37u,
    0x83613BDAu, 0xDB48A363u, 0x0B02E931u, 0x6FD15CA7u, 0x521AFACAu, 0x31338431u,
    0x6ED41A95u, 0x6D437890u, 0xC39C91F2u, 0x9ECCABBDu, 0xB5C9A0E6u, 0x532FB63Cu,
    0xD2C741C6u, 0x07237EA3u, 0xA4954B68u, 0x4C191D76u,
};

__device__ __forceinline__ uint32_t sha_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void sha_round(uint32_t& a, uint32_t& b, uint32_t& c,
                                          uint32_t& d, uint32_t& e, uint32_t& f,
                                          uint32_t& g, uint32_t& h, uint32_t kw) {
  const uint32_t s1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = h + s1 + ch + kw;
  const uint32_t s0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  h = g; g = f; f = e; e = d + t1;
  d = c; c = b; b = a; a = t1 + s0 + maj;
}

// One compression of the 16-word block w (clobbered: it holds the rolling
// schedule window) into st.
__device__ __forceinline__ void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t x = w[(t - 15) & 15], y = w[(t - 2) & 15];
      const uint32_t s0 = sha_rotr(x, 7) ^ sha_rotr(x, 18) ^ (x >> 3);
      const uint32_t s1 = sha_rotr(y, 17) ^ sha_rotr(y, 19) ^ (y >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    sha_round(a, b, c, d, e, f, g, h, SHA_K[t] + w[t & 15]);
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The compression of the constant padding block into st.
__device__ __forceinline__ void sha256_compress_pad(uint32_t st[8]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) sha_round(a, b, c, d, e, f, g, h, SHA_KW_PAD[t]);
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// st = the initial hash value.
__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// out = SHA-256(w[0..16]) for one 64-byte message; w is clobbered.
__device__ __forceinline__ void sha256_pair(uint32_t w[16], uint32_t out[8]) {
  sha256_init(out);
  sha256_compress(out, w);
  sha256_compress_pad(out);
}

// out = H(left || right) for two 8-word chunks.
__device__ __forceinline__ void sha256_hash_pair(const uint32_t left[8],
                                                 const uint32_t right[8], uint32_t out[8]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) { w[i] = left[i]; w[8 + i] = right[i]; }
  sha256_pair(w, out);
}
