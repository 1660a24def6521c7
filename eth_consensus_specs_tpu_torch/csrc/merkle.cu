// K2: the roots of a batch of SSZ lists, every tree of the batch in one
// launch: each subtree reduced, folded with zero-hash siblings up to its
// limit depth and mixed with its length.
//
// Replaces eth_consensus_specs_tpu/ops/merkle.py tree_root_words (:68) and
// many_tree_root_words (:97), and with them the list roots of
// eth_consensus_specs_tpu/ops/state_root.py: fold_to_limit (:121),
// mix_length (:138), validator_registry_root (:161), u64_list_root (:182),
// u8_list_root (:194), and of ops/block_epoch.py _slot_root (:554). The
// JAX package runs each tree as its own program, the fold a scan of one
// hash a level.
//
// Layout. The batch is a small table (ListTable, passed by value, so no
// copy to the card precedes the launch). An entry names a source and its
// kind: chunk words (int32[n, 8]), or bytes packed 32 a chunk, as u64
// values (8 bytes an item) or u8 (1 byte an item); the item count n; the
// subtree depth d (2^d leaves at level `base`, 0 unless the source is a
// subtree root reduced elsewhere); the limit depth; an optional length to
// mix; and a count of like trees at a stride (the batched entry). The grid
// is flat over every tree's leaf blocks; a block finds its entry by the
// table's prefix (block0). Only the leaf blocks that hold a live chunk are
// launched: c = ceil(n * item_bytes / 32) chunks (n for words), the rest of
// the 2^d leaves are zero, and every node wholly past them is zerohashes[l]
// without a hash.
//
// A block loads its group of at most 2^kGroupLog leaves (packing bytes into
// big-endian words as it loads them) into shared memory and hashes it level
// by level in place, a thread a pair. The tree then climbs without
// another launch (the threadfence reduction): the block writes its node to
// the scratch, fences, and adds one to its group's counter; the block that
// brings a group's count to its live children carries the group up the
// next kGroupLog levels, and so on. The block that finishes a tree's root
// runs the fold and the mix on one thread from the zero-hash table and
// writes the root. The finishers reset the counters they completed, so the
// counters stay zero between launches and need no memset. The price of the
// one launch: every leaf block of a tree deeper than one group writes its
// node, fences and counts before it exits; where one wave of blocks holds
// the whole grid, that sits on the root's path (PERF.md, K2's row).
//
// Bound on the H100: integer ALU, like K1: the live pair hashes (2^d - 1
// for a full tree), the fold and the mix, each 2,288 instructions, the
// leaves read once; and a chain: the tree's depth, the fold's levels and
// the mix are pair hashes that depend one on the next.
#include "common.cuh"
#include "sha256.cuh"

constexpr int kGroupLog = 9;                     // 512 nodes, 16 KB of shared memory
constexpr int kThreads = 1 << (kGroupLog - 1);  // a thread a pair
constexpr int kMaxTrees = 8;                     // entries of one table
constexpr int kMaxLevel = 63;                    // zero-hash rows 0..63

// One entry of the table; ops/merkle.py builds it field for field
// (LIST_TREE_DTYPE), 128 bytes.
struct ListTree {
  const uint8_t* src;    // the first tree's source
  uint32_t* out;         // the first tree's root, 8 words
  int64_t n;             // items: chunks, u64 values or bytes
  uint64_t mix_len;      // the length mixed in where mix != 0
  int64_t block0;        // the entry's first leaf block in the grid
  int64_t blocks;        // leaf blocks a tree
  int64_t src_stride;    // bytes from one tree's source to the next
  int64_t nodes0;        // the entry's first scratch node
  int64_t nodes_stride;  // scratch nodes a tree
  int64_t cnt0;          // the entry's first counter
  int64_t cnt_stride;    // counters a tree
  int64_t out_stride;    // words from one tree's root to the next
  int32_t trees;         // like trees of this entry
  int32_t item_bytes;    // 0: chunk words; 8: packed u64; 1: packed u8
  int32_t depth;         // subtree depth d
  int32_t base;          // level of the leaves
  int32_t limit;         // the level the root is folded to
  int32_t mix;           // 1: mix the length
  int64_t pad;
};
static_assert(sizeof(ListTree) == 128, "ListTree is ops/merkle.py's LIST_TREE_DTYPE");

struct ListTable {
  ListTree t[kMaxTrees];
  int32_t count;
};

// Nodes of level l that hold a live chunk (one at least: an empty tree's
// zero chunk).
__device__ __forceinline__ int64_t live_nodes(int64_t c, int l) {
  return c == 0 ? 1 : ((c - 1) >> l) + 1;
}

// Half `half` of zero-hash row `level` of a table that starts at `zh`.
__device__ __forceinline__ uint4 zh_half(const uint32_t* zh, int level, int half) {
  return __ldg(reinterpret_cast<const uint4*>(zh + 8 * level) + half);
}

__device__ __forceinline__ uint32_t be_word(uint32_t le) { return __byte_perm(le, 0, 0x0123); }

// out = H(left || right), the words from shared, global or local memory.
__device__ __forceinline__ void hash_pair(const uint32_t* left, const uint32_t* right,
                                       uint32_t* out) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = left[i];
    w[8 + i] = right[i];
  }
  sha256_pair(w, out);
}

// Half `half` (words 4 half .. 4 half + 3) of leaf chunk j of a tree.
__device__ __forceinline__ uint4 leaf_half(const ListTree& e, const uint8_t* src, int64_t j,
                                           int half, int64_t c, int64_t nbytes,
                                           const uint32_t* zh) {
  if (j >= c) return zh_half(zh, e.base, half);
  const int64_t off = j * 32 + half * 16;
  if (e.item_bytes == 0) return __ldg(reinterpret_cast<const uint4*>(src + off));
  if (off + 16 <= nbytes) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + off));
    return make_uint4(be_word(v.x), be_word(v.y), be_word(v.z), be_word(v.w));
  }
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // the list's last chunk: zero bytes past the items
    uint32_t x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t o = off + 4 * k + b;
      x = (x << 8) | (o < nbytes ? (uint32_t)src[o] : 0u);
    }
    w[k] = x;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Hash the 2^lv nodes in shared memory (node i at nodes[2i], nodes[2i + 1])
// up lv levels. The first `live` of them (1..2^lv) hold a live chunk, so
// ceil(live / 2^(l+1)) parents do at height l + 1; a pair whose parent
// holds none takes the zero hash of its level, zrow[l + 1] (zrow the zero
// hashes from the group's own level up), and is not hashed. The kernel's
// one inlined copy of the pair hash for every level of every group.
__device__ __forceinline__ void reduce_group(uint4* nodes, int lv, int live,
                                             const uint32_t* zrow) {
  const int t = threadIdx.x;
  for (int l = 0; l < lv; ++l) {
    const int pairs = 1 << (lv - l - 1);
    uint4 h0, h1;
    if (t < pairs) {
      if (t < ((live - 1) >> (l + 1)) + 1) {
        uint32_t h[8];
        hash_pair(reinterpret_cast<const uint32_t*>(nodes + 4 * t),
                  reinterpret_cast<const uint32_t*>(nodes + 4 * t + 2), h);
        h0 = make_uint4(h[0], h[1], h[2], h[3]);
        h1 = make_uint4(h[4], h[5], h[6], h[7]);
      } else {
        h0 = zh_half(zrow, l + 1, 0);
        h1 = zh_half(zrow, l + 1, 1);
      }
    }
    __syncthreads();  // every pair of this level is read before any is overwritten
    if (t < pairs) {
      nodes[2 * t] = h0;
      nodes[2 * t + 1] = h1;
    }
    __syncthreads();
  }
}

__global__ __launch_bounds__(kThreads, 6) void merkle_lists_kernel(
    const __grid_constant__ ListTable tab, const uint32_t* __restrict__ zh,
    uint32_t* __restrict__ scratch, int* __restrict__ counters) {
  __shared__ uint4 nodes[2 << kGroupLog];  // 2 x uint4 a node
  __shared__ int last;
  const int64_t b = blockIdx.x;
  int k = 0;
  while (k + 1 < tab.count && b >= tab.t[k + 1].block0) ++k;
  const ListTree& e = tab.t[k];
  const int64_t tree = (b - e.block0) / e.blocks;
  int64_t blk = (b - e.block0) - tree * e.blocks;
  const int64_t nbytes = e.item_bytes ? e.n * e.item_bytes : 32 * e.n;
  const int64_t c = (nbytes + 31) / 32;
  const uint8_t* src = e.src + tree * e.src_stride;
  uint4* scr = reinterpret_cast<uint4*>(scratch) + 2 * (e.nodes0 + tree * e.nodes_stride);
  int* cnt = counters + e.cnt0 + tree * e.cnt_stride;

  // the leaf group: a whole group of chunk words as it lies, else packed as
  // it loads
  int lv = e.depth < kGroupLog ? e.depth : kGroupLog;
  if (e.item_bytes == 0 && ((blk + 1) << lv) <= c) {
    const uint4* s = reinterpret_cast<const uint4*>(src) + 2 * (blk << lv);
    for (int q = threadIdx.x; q < (2 << lv); q += kThreads) nodes[q] = __ldg(s + q);
  } else {
    for (int q = threadIdx.x; q < (2 << lv); q += kThreads)
      nodes[q] = leaf_half(e, src, (blk << lv) + (q >> 1), q & 1, c, nbytes, zh);
  }
  __syncthreads();
  const int64_t leaf_live = live_nodes(c, 0) - (blk << lv);
  int live = leaf_live < (1 << lv) ? (int)leaf_live : 1 << lv;

  // reduce the group, then climb: the last block of each group carries it
  // up the next levels
  int level = 0;
  int64_t nodes_off = 0, cnt_off = 0;
  for (;;) {
    reduce_group(nodes, lv, live, zh + 8 * (e.base + level));
    level += lv;
    if (level >= e.depth) break;
    const int64_t in = live_nodes(c, level);
    lv = e.depth - level < kGroupLog ? e.depth - level : kGroupLog;
    const int64_t group = blk >> lv;
    const int64_t first = group << lv;
    const int64_t children = in - first < (int64_t(1) << lv) ? in - first : (int64_t(1) << lv);
    if (threadIdx.x < 2) __stcg(scr + 2 * (nodes_off + blk) + threadIdx.x, nodes[threadIdx.x]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int prev = atomicAdd(cnt + cnt_off + group, 1);
      last = prev == children - 1;
      if (last) cnt[cnt_off + group] = 0;  // complete: clean for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int q = threadIdx.x; q < (2 << lv); q += kThreads)
      nodes[q] = (q >> 1) < children ? __ldcg(scr + 2 * (nodes_off + first) + q)
                                     : zh_half(zh, e.base + level, q & 1);
    __syncthreads();
    nodes_off += in;
    cnt_off += live_nodes(c, level + lv);
    blk = group;
    live = (int)children;
  }

  // the root: fold to the limit, then mix the length (the right half the
  // length chunk), one thread, one inlined copy of the pair hash
  if (threadIdx.x == 0) {
    uint32_t r[8];
    const uint4 lo = nodes[0], hi = nodes[1];
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
    const uint32_t m[8] = {be_word((uint32_t)e.mix_len), be_word((uint32_t)(e.mix_len >> 32)),
                           0, 0, 0, 0, 0, 0};
    for (int l = e.base + e.depth; l < e.limit + e.mix; ++l) {
      uint32_t h[8];
      hash_pair(r, l < e.limit ? zh + 8 * l : m, h);
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = h[i];
    }
    uint4* out = reinterpret_cast<uint4*>(e.out + tree * e.out_stride);
    out[0] = make_uint4(r[0], r[1], r[2], r[3]);
    out[1] = make_uint4(r[4], r[5], r[6], r[7]);
  }
}

// table: `count` ListTree entries in host memory (block0 the prefix of the
// entries' trees x blocks); zh: u32[kMaxLevel + 1, 8] zero hashes on the
// card; scratch: u32[nodes, 8]; counters: int32, zero, with room for every
// entry's cnt0 + trees x cnt_stride; blocks: the grid, the sum of trees x
// blocks.
extern "C" int merkle_lists_launch(const void* table, int count, const void* zh, void* scratch,
                                   void* counters, int64_t blocks, cudaStream_t stream) {
  if (count < 1 || count > kMaxTrees || blocks < 1 || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ListTable tab = {};
  const ListTree* in = static_cast<const ListTree*>(table);
  int64_t next = 0;
  for (int i = 0; i < count; ++i) {
    const ListTree& e = in[i];
    if (e.block0 != next || e.trees < 1 || e.blocks < 1 || e.depth < 0 || e.base < 0 ||
        e.base + e.depth > e.limit || e.limit > kMaxLevel || e.n < 0 ||
        (e.item_bytes != 0 && e.item_bytes != 1 && e.item_bytes != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    next += e.trees * e.blocks;
    tab.t[i] = e;
  }
  if (next != blocks) return static_cast<int>(cudaErrorInvalidValue);
  tab.count = count;
  merkle_lists_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      tab, static_cast<const uint32_t*>(zh), static_cast<uint32_t*>(scratch),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}
