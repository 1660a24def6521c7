// K5 and K6 redesigned: every tree of the incremental forest updated in one
// launch, hashing only the nodes above a dirty leaf.
//
// Replaces eth_consensus_specs_tpu/ops/merkle_inc.py build_levels (:109),
// path_update (:140), apply_dirty (:170) and build_forest (:219) behind
// _apply_kernel (:310), and the leaf chain of ops/state_root.py
// _validator_leaf_fn (:721) as post_epoch_state_root_inc (:805) runs them:
// the JAX package updates each tree as its own program, and picks the sparse
// path update or the dense rebuild with a lax.cond on the tree's live dirty
// count. Both give the same node buffer, and so does this kernel's one rule:
// hash a node when one of its children is dirty, read a clean child from its
// stored row. A group whose leaves are all dirty hashes every node, as the
// rebuild does; a group with two dirty leaves hashes their paths, as the path
// update does; a clean group hashes nothing. No count has to be known before
// hashing starts, so there is no grid barrier, no cooperative launch and no
// branch launched only to return at its gate. (The plain twin,
// ops/merkle_inc.py forest_update_ref, keeps the JAX package's branches and
// the forest plan's capacities; this rule is the kernel's own.)
//
// The flat layout is the JAX package's: a tree of depth d is 2^(d+1) - 1 rows
// of 8 words, leaves first, root last, level k at row 2^(d+1) - 2^(d-k+1).
// Every level stays resident: each node hashed is written to its row.
//
// Table. The trees of a launch are a small table (ForestTable, passed by
// value, as K2's ListTable in merkle.cu). An entry names a flat node buffer,
// its depth and a leaf source of one kind:
//   kU64      a u64 column diff, old and new, `per` values a leaf (4: the
//             balances and the inactivity scores): a leaf is dirty where a
//             value differs, and its new chunk is written to its row;
//   kRegistry the registry diff, old and new effective balance, one a leaf:
//             a dirty leaf is the validator chain (validator_root.cuh) of the
//             new balance, computed here and written to its row;
//   kMask     a byte mask over the leaves, with the new leaf rows from a
//             tensor or already in their rows (update_forest, apply_dirty,
//             path_update after its mark pass); with `clear`, each set byte
//             is reset as it is read (path_update's scratch mask, so that
//             no call zeroes 2^d bytes);
//   kAll      every leaf dirty, rows in place, over a batch of like trees
//             (build_levels, merkle_levels: the forest build, the restore's
//             check, the scrub's subtrees, the quarantine rebuild); with a
//             gate, only when *gate > gate_dense.
// Only the leaf groups that hold a live leaf are launched (live: the values'
// leaves, the validators, the mask's length, or all 2^d); a node wholly past
// them is never dirty, so its parents are counted on its live siblings alone.
// The grid is flat over every tree's leaf groups; a block finds its entry by
// the table's prefix (block0).
//
// Groups. A block of 128 threads owns a group of at most 2^9 leaves. It
// finds which of them are dirty, writes their new rows and keeps a dirty bit
// a node of the group in shared memory; then level by level a thread a pair
// (two at the first level) hashes only the parents with a dirty child, the
// dirty child from shared memory, a clean one from its stored row; the
// levels alternate between two buffers, one barrier a level. It adds its
// dirty count to its tree's accumulator. 128 threads and 8 blocks an SM
// (64 registers) timed best against 256 threads at 2 to 4 an SM, 128 at 10
// and 12, and 64 threads at 16 an SM reading every child from its row
// (tools/forest_times.py). A sparse group hashes its few paths on a thread
// or two, a chain of 9 pair hashes whose every level also waits on a clean
// sibling's row: a sparse update is latency-bound (on the H100, one dirty
// leaf of a 2^20 tree ~0.075 ms, 4,072 random ones ~0.20, every leaf
// ~0.28).
//
// The climb, as K2's: a block writes its group's top node (in the hashing
// above), stores the node's dirty flag, fences, and adds one to its parent
// group's counter, the flag in the counter's high half. The block that brings
// the count to the group's live children carries the group up the next 9
// levels, loading the dirty children's rows and hashing only the dirty
// parents; when no child is dirty it passes "clean" upward without loading or
// hashing. Finishers reset the counters they complete, and the root's
// finisher publishes the tree's dirty count and resets its accumulator, so
// the scratch is zero between launches and needs no memset.
//
// Bound on the H100: integer ALU on the dirty parents' pair hashes (2,288
// instructions each) and the dirty validators' chains (3 each), or bytes
// (each value read once, each written row once); and a chain of dependent
// pair hashes, the tree's depth (plus 3 for a registry leaf), which a sparse
// update sits on.
#include "common.cuh"
#include "sha256.cuh"
#include "validator_root.cuh"

constexpr int kGroupLog = 9;      // 512 nodes, 16 KB of shared memory (and 8 KB for odd levels)
constexpr int kThreads = 128;     // four leaves a thread, a pair a thread from level 1
constexpr int kBlocksPerSm = 8;   // 64 registers a thread
constexpr int kMaxTrees = 8;                     // entries of one table
constexpr int kMarkThreads = 256;

enum Kind : int32_t { kU64 = 0, kRegistry = 1, kMask = 2, kAll = 3 };

// One entry of the table; ops/merkle_inc.py builds it field for field
// (FOREST_TREE_DTYPE), 176 bytes.
struct ForestTree {
  uint32_t* nodes;          // the first tree's flat buffer
  const uint64_t* old_v;    // kU64, kRegistry: the old values
  const uint64_t* new_v;    // kU64, kRegistry: the new values
  uint8_t* mask;            // kMask: the dirty leaves
  const uint32_t* rows;     // kMask: the new leaf rows, or null: in place
  const uint32_t* slashed;  // kRegistry: the static chunks and nodes
  const uint32_t* node_a;
  const uint32_t* node_f;
  int* count;               // the tree's dirty count, written, or null
  const int* gate;          // kAll: runs only when *gate > gate_dense; null: always
  int64_t n;                // values, validators or mask entries (kAll: 2^depth)
  int64_t live;             // leaves that hold a value
  int64_t block0;           // the entry's first leaf block in the grid
  int64_t blocks;           // leaf blocks a tree
  int64_t nodes_stride;     // rows from one tree's buffer to the next
  int64_t cnt0;             // the entry's first counter
  int64_t cnt_stride;       // counters a tree: the climb's groups, then the accumulator
  int64_t flag0;            // the entry's first flag
  int64_t flag_stride;      // flags a tree: one a child node of the climb
  int32_t trees;            // like trees of this entry (kAll)
  int32_t kind;
  int32_t depth;
  int32_t per;              // kU64: values a leaf, 1..4
  int32_t gate_dense;
  int32_t clear;             // kMask: reset each set byte as it is read
};
static_assert(sizeof(ForestTree) == 176, "ForestTree is ops/merkle_inc.py's FOREST_TREE_DTYPE");

struct ForestTable {
  ForestTree t[kMaxTrees];
  int32_t count;
};

// Nodes of level l that hold a live leaf (one at least).
__device__ __forceinline__ int64_t live_nodes(int64_t c, int l) {
  return c == 0 ? 1 : ((c - 1) >> l) + 1;
}

// Node i of level `level` of a tree whose level-0 row 0 is at `tree`.
__device__ __forceinline__ uint4* node_row(uint32_t* tree, int64_t cap2, int level, int64_t i) {
  return reinterpret_cast<uint4*>(tree) + 2 * (cap2 - (cap2 >> level) + i);
}

// Is leaf `leaf` of a u64 diff or a mask dirty? If so, its new row in r,
// and whether the row must be written (its source is not the row itself).
__device__ __forceinline__ bool leaf_row(const ForestTree& e, const uint4* stored, int64_t leaf,
                                         uint4 r[2], bool& write) {
  write = e.kind != kMask || e.rows != nullptr;
  if (e.kind == kU64) {
    bool dirty = false;
    uint64_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t i = leaf * e.per + q;
      if (q < e.per && i < e.n) {
        v[q] = e.new_v[i];
        dirty |= e.old_v[i] != v[q];
      }
    }
    r[0] = make_uint4(bswap32((uint32_t)v[0]), bswap32((uint32_t)(v[0] >> 32)),
                      bswap32((uint32_t)v[1]), bswap32((uint32_t)(v[1] >> 32)));
    r[1] = make_uint4(bswap32((uint32_t)v[2]), bswap32((uint32_t)(v[2] >> 32)),
                      bswap32((uint32_t)v[3]), bswap32((uint32_t)(v[3] >> 32)));
    return dirty;
  }
  if (e.mask[leaf] == 0) return false;
  if (e.clear) e.mask[leaf] = 0;
  const uint4* src = e.rows != nullptr ? reinterpret_cast<const uint4*>(e.rows) + 2 * leaf
                                       : stored + 2 * leaf;
  r[0] = src[0];
  r[1] = src[1];
  return true;
}

// Hash the dirty parents of one group of 2^lv nodes of level `level`, the
// first of them node `first`, up lv levels. Even levels' values lie in
// na (node i at 2i, 2i + 1, where da[i]), odd levels' in nb and db, a clean
// node's in its stored row; a level's parents go to the other buffer, so a
// level needs one barrier. Every parent hashed is written to its row. The
// group's top node ends in na/da or nb/db as lv is even or odd. The
// kernel's one inlined copy of the pair hash for the tree's levels.
__device__ __forceinline__ void hash_dirty(uint4* na, uint4* nb, int* da, int* db, uint32_t* tree,
                                           int64_t cap2, int level, int lv, int64_t first) {
  for (int l = 0; l < lv; ++l) {
    const uint4* src = l & 1 ? nb : na;
    const int* ds = l & 1 ? db : da;
    uint4* dst = l & 1 ? na : nb;
    int* dd = l & 1 ? da : db;
    const int pairs = 1 << (lv - l - 1);
    for (int t = threadIdx.x; t < pairs; t += kThreads) {
      const bool dl = ds[2 * t], dr = ds[2 * t + 1];
      if (dl || dr) {
        const uint4* child = node_row(tree, cap2, level + l, (first >> l) + 2 * t);
        uint4 q[4];
        q[0] = dl ? src[4 * t] : __ldcg(child);
        q[1] = dl ? src[4 * t + 1] : __ldcg(child + 1);
        q[2] = dr ? src[4 * t + 2] : __ldcg(child + 2);
        q[3] = dr ? src[4 * t + 3] : __ldcg(child + 3);
        uint32_t w[16], h[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[4 * k] = q[k].x; w[4 * k + 1] = q[k].y; w[4 * k + 2] = q[k].z; w[4 * k + 3] = q[k].w;
        }
        sha256_pair(w, h);
        const uint4 h0 = make_uint4(h[0], h[1], h[2], h[3]);
        const uint4 h1 = make_uint4(h[4], h[5], h[6], h[7]);
        dst[2 * t] = h0;
        dst[2 * t + 1] = h1;
        uint4* out = node_row(tree, cap2, level + l + 1, (first >> (l + 1)) + t);
        out[0] = h0;
        out[1] = h1;
      }
      dd[t] = dl || dr;
    }
    __syncthreads();
  }
}

// A dirty registry leaf: the validator chain, out of line so that its three
// pair hashes do not crowd the tree's loop.
__device__ __noinline__ void registry_leaf(const uint64_t* eff, const uint32_t* slashed,
                                           const uint32_t* node_a, const uint32_t* node_f,
                                           int64_t leaf, uint4 r[2]) {
  uint32_t w[8];
  validator_root(eff, slashed, node_a, node_f, leaf, w);
  r[0] = make_uint4(w[0], w[1], w[2], w[3]);
  r[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ __launch_bounds__(kThreads, kBlocksPerSm) void forest_update_kernel(
    const __grid_constant__ ForestTable tab, int* __restrict__ counters, int* __restrict__ flags) {
  __shared__ uint4 nodes_a[2 << kGroupLog];  // 2 x uint4 a node: levels 0, 2, 4, ...
  __shared__ uint4 nodes_b[1 << kGroupLog];  // levels 1, 3, ...
  __shared__ int dirty_a[1 << kGroupLog];
  __shared__ int dirty_b[1 << (kGroupLog - 1)];
  __shared__ int last, some_dirty;
  const int64_t b = blockIdx.x;
  int k = 0;
  while (k + 1 < tab.count && b >= tab.t[k + 1].block0) ++k;
  const ForestTree& e = tab.t[k];
  if (e.gate != nullptr && *e.gate <= e.gate_dense) return;  // the whole entry: no counter moves
  const int64_t tree_i = (b - e.block0) / e.blocks;
  int64_t blk = (b - e.block0) - tree_i * e.blocks;
  uint32_t* tree = e.nodes + tree_i * e.nodes_stride * 8;
  const int64_t cap2 = 2LL << e.depth;
  int* cnt = counters + e.cnt0 + tree_i * e.cnt_stride;
  int* acc = cnt + e.cnt_stride - 1;
  int* flag = flags + e.flag0 + tree_i * e.flag_stride;
  const int t = threadIdx.x;

  // the leaf group: which leaves are dirty, their new rows written
  int lv = e.depth < kGroupLog ? e.depth : kGroupLog;
  int found = 0;
  if (e.kind == kAll) {
    const uint4* src = node_row(tree, cap2, 0, blk << lv);
    for (int q = t; q < (2 << lv); q += kThreads) nodes_a[q] = src[q];
    for (int j = t; j < (1 << lv); j += kThreads) dirty_a[j] = 1;
    found = 1 << lv;
    __syncthreads();
  } else {
    const uint4* stored = node_row(tree, cap2, 0, 0);
#pragma unroll 1
    for (int round = 0; round < (1 << kGroupLog) / kThreads; ++round) {
      const int j = t + round * kThreads;
      const int64_t leaf = (blk << lv) + j;
      bool d = false;
      if (j < (1 << lv) && leaf < e.live) {
        uint4 r[2];
        bool write = true;
        if (e.kind == kRegistry) {
          d = e.old_v[leaf] != e.new_v[leaf];
          if (d) registry_leaf(e.new_v, e.slashed, e.node_a, e.node_f, leaf, r);
        } else {
          d = leaf_row(e, stored, leaf, r, write);
        }
        if (d) {
          nodes_a[2 * j] = r[0];
          nodes_a[2 * j + 1] = r[1];
          if (write) {
            uint4* row = node_row(tree, cap2, 0, leaf);
            row[0] = r[0];
            row[1] = r[1];
          }
        }
      }
      if (j < (1 << lv)) dirty_a[j] = d;
      found += __syncthreads_count(d);
    }
  }
  if (t == 0 && found) atomicAdd(acc, found);

  // hash the group, then climb: the last block of each group carries it up
  // the next levels
  int level = 0;
  int64_t flag_off = 0, cnt_off = 0;
  for (;;) {
    hash_dirty(nodes_a, nodes_b, dirty_a, dirty_b, tree, cap2, level, lv, blk << lv);
    const int top = lv & 1 ? dirty_b[0] : dirty_a[0];
    level += lv;
    if (level >= e.depth) break;
    const int64_t in = live_nodes(e.live, level);
    lv = e.depth - level < kGroupLog ? e.depth - level : kGroupLog;
    const int64_t group = blk >> lv;
    const int64_t first = group << lv;
    const int64_t children = in - first < (int64_t(1) << lv) ? in - first : (int64_t(1) << lv);
    if (t == 0) {  // the thread that wrote the group's top node
      __stcg(flag + flag_off + blk, top);
      __threadfence();
      const int prev = atomicAdd(cnt + cnt_off + group, 1 + (top << 16));
      last = (prev & 0xFFFF) == children - 1;
      some_dirty = (prev >> 16) + top > 0;
      if (last) cnt[cnt_off + group] = 0;  // complete: clean for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const bool some = some_dirty;
    for (int q = t; q < (1 << lv); q += kThreads) {
      const int d = some && q < children ? __ldcg(flag + flag_off + first + q) : 0;
      dirty_a[q] = d;
      if (d) {
        const uint4* src = node_row(tree, cap2, level, first + q);
        nodes_a[2 * q] = __ldcg(src);
        nodes_a[2 * q + 1] = __ldcg(src + 1);
      }
    }
    __syncthreads();
    flag_off += in;
    cnt_off += live_nodes(e.live, level + lv);
    blk = group;
  }
  if (t == 0) {  // the root's finisher: publish the count, reset the accumulator
    const int c = atomicExch(acc, 0);
    if (e.count != nullptr) *e.count = c;
  }
}

// path_update's first pass: leaf idx[j] of j < min(*count, cap) (all cap
// when count is null; none when dense >= 0 and *count > dense) marked in
// mask, and vals[j] written to its row when vals is set. An index outside
// [0, n_leaves) is skipped.
__global__ void forest_mark_kernel(uint32_t* __restrict__ nodes, int64_t n_leaves,
                                   const int* __restrict__ idx, int cap,
                                   const uint32_t* __restrict__ vals, const int* __restrict__ count,
                                   int dense, uint8_t* __restrict__ mask) {
  int live = cap;
  if (count != nullptr) {
    live = *count;
    if (dense >= 0 && live > dense) return;
    live = live < cap ? live : cap;
  }
  const int64_t j = blockIdx.x * (int64_t)kMarkThreads + threadIdx.x;
  if (j >= live) return;
  const int64_t leaf = idx[j];
  if (leaf < 0 || leaf >= n_leaves) return;
  if (vals != nullptr) {
    const uint4* v = reinterpret_cast<const uint4*>(vals) + 2 * j;
    uint4* row = reinterpret_cast<uint4*>(nodes) + 2 * leaf;
    row[0] = v[0];
    row[1] = v[1];
  }
  mask[leaf] = 1;
}

// table: `count` ForestTree entries in host memory (block0 the prefix of the
// entries' trees x blocks); counters: int32, zero, with room for every
// entry's cnt0 + trees x cnt_stride; flags: int32, one a climb node;
// blocks: the grid, the sum of trees x blocks.
extern "C" int forest_update_launch(const void* table, int count, void* counters, void* flags,
                                    int64_t blocks, cudaStream_t stream) {
  if (count < 1 || count > kMaxTrees || blocks < 1 || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ForestTable tab = {};
  const ForestTree* in = static_cast<const ForestTree*>(table);
  int64_t next = 0;
  for (int i = 0; i < count; ++i) {
    const ForestTree& e = in[i];
    const bool source_ok =
        (e.kind == kU64 && e.old_v && e.new_v && e.per >= 1 && e.per <= 4) ||
        (e.kind == kRegistry && e.old_v && e.new_v && e.slashed && e.node_a && e.node_f) ||
        (e.kind == kMask && e.mask) || e.kind == kAll;
    if (e.block0 != next || e.trees < 1 || (e.trees > 1 && e.kind != kAll) || e.blocks < 1 ||
        e.depth < 0 || e.depth > 30 || e.n < 0 || e.live < 0 || e.live > (1LL << e.depth) ||
        e.cnt_stride < 1 || !e.nodes || !source_ok)
      return static_cast<int>(cudaErrorInvalidValue);
    next += e.trees * e.blocks;
    tab.t[i] = e;
  }
  if (next != blocks) return static_cast<int>(cudaErrorInvalidValue);
  tab.count = count;
  forest_update_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      tab, static_cast<int*>(counters), static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// nodes: a depth-d flat tree (its leaf rows first), n_leaves = 2^d; idx:
// int32[cap]; vals: cap x 8 words or null; count: int32[1] or null; mask:
// uint8[n_leaves], zero where it is not to be marked.
extern "C" int forest_mark_launch(void* nodes, int64_t n_leaves, const void* idx, int cap,
                                  const void* vals, const void* count, int dense, void* mask,
                                  cudaStream_t stream) {
  if (cap < 1 || n_leaves < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (cap + kMarkThreads - 1) / kMarkThreads;
  forest_mark_kernel<<<blocks, kMarkThreads, 0, stream>>>(
      static_cast<uint32_t*>(nodes), n_leaves, static_cast<const int*>(idx), cap,
      static_cast<const uint32_t*>(vals), static_cast<const int*>(count), dense,
      static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}
