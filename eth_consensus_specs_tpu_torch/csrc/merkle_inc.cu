// K5: the dirty-leaf compaction of a flat merkle tree's update.
//
// Replaces eth_consensus_specs_tpu/ops/merkle_inc.py dirty_indices (:125):
// the compacted dirty set JAX's sparse branch (apply_dirty :170) feeds its
// path update. Since the forest update (forest_update.cu) hashes every tree
// of the forest in one launch from the column diffs themselves, no path of
// the port compacts; this entry stays behind the public dirty_indices and
// dirty_leaves, their counterparts.
//
// Compaction (merkle_dirty_launch). A leaf is dirty where a bool mask says
// so, or where its u64 values differ between the old and the new column
// (`per` values per leaf: 1 for the validator registry's effective
// balances, 4 for a packed balance or score chunk). The dirty leaf indices
// are written in ascending order into idx[cap], padded with 0, and the live
// count into *count; entries past cap are dropped, as JAX drops them. For a
// chunk tree the kernel also writes each dirty leaf's new chunk into its
// leaf row.
//
// One ordinary launch, one pass over the leaves (a single-pass scan with
// decoupled look-back: Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016). A block takes a tile of 256 threads x
// 16 values: 16 mask bytes a thread as one 16-byte load, or 16 u64 of each
// column as 16-byte loads (16 / per leaves a thread). Its dirty count comes
// from a block scan; it then publishes that count in its tile's status word
// and looks back, one warp reading 32 predecessors' words at a time, until
// it meets a tile whose inclusive prefix is known; it publishes its own
// inclusive prefix and writes its indices (and leaf rows) in order. The last
// tile writes *count and the zero padding past it. Tiles are drawn from a
// ticket counter, so a tile waits only on tiles already running; the block
// that draws the last ticket resets the counter. A status word is
// generation << 34 | state << 32 | count, written with one 64-bit store;
// the host passes a new generation each call, so no status word is ever
// reset (the host zeroes the array once when its generation wraps).
// Bound by bytes: each input value read once, the indices written once.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kValues = 16;                // values a thread loads (mask bytes or u64 per column)
constexpr uint64_t kAggregate = 1, kPrefix = 2;  // states of a status word
constexpr int kGenShift = 34;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// Leaves a thread takes: 16 mask bytes, or 16 / per leaves of per u64 values.
template <int PER>
struct Form {
  static constexpr int kLeaves = PER == 0 ? kValues : kValues / PER;
  static constexpr int kTile = kThreads * kLeaves;
};

struct LeafSource {
  const uint8_t* mask;    // bool[n_items], or null to diff old vs new
  const uint64_t* old_v;  // u64[n_items]
  const uint64_t* new_v;  // u64[n_items]
  int64_t n_items;
  uint32_t* leaf_rows;    // non-null: write the new chunk of each dirty leaf
};

// Bit k set: leaf leaf0 + k is dirty. Mask form.
__device__ __forceinline__ uint32_t mask_bits(const LeafSource& s, int64_t leaf0) {
  uint32_t bits = 0;
  if ((reinterpret_cast<uintptr_t>(s.mask) & 15) == 0 && leaf0 + kValues <= s.n_items) {
    const uint4 w = *reinterpret_cast<const uint4*>(s.mask + leaf0);
    const uint32_t q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bits |= static_cast<uint32_t>(((q[j] >> (8 * b)) & 0xFF) != 0) << (4 * j + b);
  } else {
#pragma unroll
    for (int k = 0; k < kValues; ++k)
      if (leaf0 + k < s.n_items && s.mask[leaf0 + k] != 0) bits |= 1u << k;
  }
  return bits;
}

// Diff form: bit k set where a value of leaf leaf0 + k differs; nv holds the
// new values (0 past n_items).
template <int PER>
__device__ __forceinline__ uint32_t diff_bits(const LeafSource& s, int64_t leaf0,
                                              uint64_t (&nv)[kValues]) {
  constexpr int kLeaves = Form<PER>::kLeaves;
  const int64_t v0 = leaf0 * PER;
  bool d[kValues];
  const uintptr_t base = reinterpret_cast<uintptr_t>(s.old_v) | reinterpret_cast<uintptr_t>(s.new_v);
  const bool vec = kLeaves * PER == kValues && (base & 15) == 0 && v0 + kValues <= s.n_items;
  if (vec) {
    const ulonglong2* o = reinterpret_cast<const ulonglong2*>(s.old_v + v0);
    const ulonglong2* n = reinterpret_cast<const ulonglong2*>(s.new_v + v0);
    ulonglong2 ov[kValues / 2], nw[kValues / 2];
#pragma unroll
    for (int q = 0; q < kValues / 2; ++q) {
      ov[q] = o[q];
      nw[q] = n[q];
    }
#pragma unroll
    for (int q = 0; q < kValues / 2; ++q) {
      nv[2 * q] = nw[q].x;
      nv[2 * q + 1] = nw[q].y;
      d[2 * q] = ov[q].x != nw[q].x;
      d[2 * q + 1] = ov[q].y != nw[q].y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kValues; ++q) {
      const int64_t i = v0 + q;
      nv[q] = 0;
      d[q] = false;
      if (q < kLeaves * PER && i < s.n_items) {
        nv[q] = s.new_v[i];
        d[q] = s.old_v[i] != nv[q];
      }
    }
  }
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kLeaves; ++k) {
    bool any = false;
#pragma unroll
    for (int q = 0; q < PER; ++q) any |= d[k * PER + q];
    bits |= static_cast<uint32_t>(any) << k;
  }
  return bits;
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t gen, uint64_t state,
                                             uint32_t count) {
  *reinterpret_cast<volatile uint64_t*>(p) = gen << kGenShift | state << 32 | count;
}

// The exclusive prefix of tile `tile` (> 0): warp 0 reads the status words
// of the 32 tiles before a window's end, each lane spinning until its word
// carries this call's generation, sums the counts up to the nearest
// inclusive prefix, and moves the window back until it meets one.
__device__ __forceinline__ uint32_t look_back(const uint64_t* status, int64_t tile, uint64_t gen) {
  const int lane = threadIdx.x & 31;
  uint32_t exclusive = 0;
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t t = end - lane;
    uint64_t w = gen << kGenShift | kPrefix << 32;  // before tile 0: a prefix of 0
    if (t >= 0) {
      do {
        w = load_status(status + t);
      } while ((w >> kGenShift) != gen || ((w >> 32) & 3) == 0);
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, ((w >> 32) & 3) == kPrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    uint32_t v = lane <= stop ? static_cast<uint32_t>(w) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    exclusive += v;
    if (prefix) return exclusive;
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
dirty_compact_kernel(LeafSource s, int64_t n_leaves, int64_t tiles, int cap, int* __restrict__ idx,
                     int* __restrict__ count, unsigned long long* __restrict__ scratch,
                     uint64_t gen) {
  constexpr int kLeaves = Form<PER>::kLeaves;
  __shared__ int64_t tile_s;
  __shared__ uint32_t warp_count[kWarps];
  __shared__ uint32_t base_s;
  // scratch[0]: the ticket counter; scratch[1 + t]: tile t's status word
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(scratch, 1ull);
    if (t == static_cast<unsigned long long>(tiles - 1)) atomicExch(scratch, 0ull);
    tile_s = static_cast<int64_t>(t);
  }
  __syncthreads();
  const int64_t tile = tile_s;
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t leaf0 = tile * Form<PER>::kTile + static_cast<int64_t>(threadIdx.x) * kLeaves;

  uint64_t nv[kValues];
  uint32_t bits;
  if constexpr (PER == 0) {
    bits = mask_bits(s, leaf0);
  } else {
    bits = diff_bits<PER>(s, leaf0, nv);
  }
  if (leaf0 >= n_leaves) bits = 0;
  else if (n_leaves - leaf0 < kLeaves) bits &= (1u << (n_leaves - leaf0)) - 1u;

  // block scan of the threads' dirty counts
  const uint32_t mine = __popc(bits);
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  uint32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w];
    before += w < warp ? c : 0u;
    agg += c;
  }
  if (warp == 0) {
    uint32_t exclusive = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, gen, kPrefix, agg);
    } else {
      if (lane == 0) store_status(status + tile, gen, kAggregate, agg);
      exclusive = look_back(status, tile, gen);
      if (lane == 0) store_status(status + tile, gen, kPrefix, exclusive + agg);
    }
    if (lane == 0) base_s = exclusive;
  }
  __syncthreads();
  const uint32_t base = base_s;

  // this thread's dirty leaves, in order
  int64_t pos = static_cast<int64_t>(base) + before + incl - mine;
#pragma unroll
  for (int k = 0; k < kLeaves; ++k) {
    if (!((bits >> k) & 1u)) continue;
    const int64_t leaf = leaf0 + k;
    if (pos < cap) idx[pos] = static_cast<int>(leaf);
    ++pos;
    if constexpr (PER != 0) {
      if (s.leaf_rows != nullptr) {
        uint64_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < PER; ++q) v[q] = nv[k * PER + q];
        uint4* row = reinterpret_cast<uint4*>(s.leaf_rows + leaf * 8);
        row[0] = make_uint4(bswap32((uint32_t)v[0]), bswap32((uint32_t)(v[0] >> 32)),
                            bswap32((uint32_t)v[1]), bswap32((uint32_t)(v[1] >> 32)));
        row[1] = make_uint4(bswap32((uint32_t)v[2]), bswap32((uint32_t)(v[2] >> 32)),
                            bswap32((uint32_t)v[3]), bswap32((uint32_t)(v[3] >> 32)));
      }
    }
  }

  // the last tile: the total and the padding past it
  if (tile == tiles - 1) {
    const int64_t total = static_cast<int64_t>(base) + agg;
    if (threadIdx.x == 0) *count = static_cast<int>(total);
    for (int64_t p = total + threadIdx.x; p < cap; p += kThreads) idx[p] = 0;
  }
}

template <int PER>
static cudaError_t launch_form(const LeafSource& s, int64_t n_leaves, int cap, int* idx, int* count,
                               unsigned long long* scratch, int64_t scratch_len, uint64_t gen,
                               cudaStream_t stream) {
  const int64_t tiles = (n_leaves + Form<PER>::kTile - 1) / Form<PER>::kTile;
  if (tiles + 1 > scratch_len || tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  dirty_compact_kernel<PER><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      s, n_leaves, tiles, cap, idx, count, scratch, gen);
  return cudaGetLastError();
}

// Dirty-leaf compaction of n_leaves leaves into idx[cap] (ascending, padded
// with 0) and *count. Either mask (bool[n_items]) is set, or old and new
// (u64[n_items], `per` values a leaf); leaf_rows (n_leaves x 8 words), when
// set with old/new, receives the new chunk of every dirty leaf. scratch:
// u64[scratch_len], word 0 the ticket counter (0 between launches), then a
// status word a tile; gen: this call's generation, in [1, 2^30), not the
// generation of any word left in the array.
extern "C" int merkle_dirty_launch(const void* mask, const void* old_v, const void* new_v,
                                   int64_t n_items, int per, void* leaf_rows, int64_t n_leaves,
                                   int cap, void* idx, void* count, void* scratch,
                                   int64_t scratch_len, int64_t gen, cudaStream_t stream) {
  if (n_leaves < 1 || n_leaves > (1LL << 31) - 1 || cap < 1 || per < 1 || per > 4 ||
      gen < 1 || gen >= (1LL << 30) ||
      (mask == nullptr && (old_v == nullptr || new_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  LeafSource s{static_cast<const uint8_t*>(mask), static_cast<const uint64_t*>(old_v),
               static_cast<const uint64_t*>(new_v), n_items, static_cast<uint32_t*>(leaf_rows)};
  using Launch = cudaError_t (*)(const LeafSource&, int64_t, int, int*, int*, unsigned long long*,
                                 int64_t, uint64_t, cudaStream_t);
  static const Launch forms[] = {launch_form<0>, launch_form<1>, launch_form<2>, launch_form<3>,
                                 launch_form<4>};
  return static_cast<int>(forms[mask != nullptr ? 0 : per](
      s, n_leaves, cap, static_cast<int*>(idx), static_cast<int*>(count),
      static_cast<unsigned long long*>(scratch), scratch_len, static_cast<uint64_t>(gen), stream));
}
