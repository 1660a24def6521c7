// 32-bit carry chains in PTX, shared by the field products of the BLS
// kernels (bls_fp.cuh, Fq) and of K16 (fr.cuh, Fr): on this card a 64-bit
// limb is emulated, so the products run on 32-bit lanes with the carry
// flag between instructions (mad.lo.cc / madc.hi.cc, add.cc / addc).
//
// Each helper is one instruction; the carry flag lives between them, so a
// chain is a run of asm volatile statements back to back (volatile keeps
// their order, and nothing the compiler emits in between touches the
// flag).
#pragma once
#include "common.cuh"

__device__ __forceinline__ uint32_t ptx_mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t ptx_madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t ptx_mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t ptx_madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t ptx_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t ptx_add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t ptx_addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t ptx_addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t ptx_sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t ptx_subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t ptx_subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

