// K5 dedup_rows: the distinct rows of an [n, C] u32 matrix given as up to
// nine column blocks side by side (int32 or bool, each read in place), each
// row's index among them, and their count.
//
// Replaces karpenter_tpu/solver/tpu.py:264 `_dedup_decode_state` (its
// device part, the packing of the claim columns included). The output
// equals the reference's bit for bit:
//   1. two wrapping u32 row hashes, h1 = sum_j row[j] * (2j+1) * 2654435761
//      and h2 = sum_j (row[j] + j) * (2j+1) * 2246822519, j the word's index
//      in the packed row and a bool widened to 0/1: one warp a row, exact in
//      any order of summation;
//   2. the rows ordered by (h1, h2, row index), which is the reference's
//      stable jnp.lexsort((h2, h1));
//   3. each sorted row whose key equals its predecessor's compared with it
//      in full (a warp a pair): hash collisions only leave equal rows
//      apart, never merge distinct ones;
//   4. a scan of the "new row" flags gives each sorted row its unique
//      index; inv[order[s]], the unique rows at the front of `compact`,
//      zeros after them, and n_uniq are written.
//
// Bound on an H100: bytes (the rows read once, compact and inv written
// once: about 3 MB at the headline's n = 2048, C = 184). What decides in
// practice is latency: a chain of dependent phases, each a few thousand
// cycles of one SM's instructions. Up to 8192 rows it is one launch of a
// thread-block cluster (up to 16 CTAs, one an SM, a CTA a 128-row
// sub-chunk or more) that shares its phases through distributed shared
// memory, with three cluster barriers and no global scratch:
//   a. where its rows fit (the stash, below: the headline's do), each CTA
//      copies its rows into shared memory packed as the reference packs
//      them; it starts its slice of compact's zeros (bulk copies of a
//      zeroed shared buffer by the tensor memory accelerator, which run on
//      while the CTA computes), hashes its rows (a warp a row) and ranks
//      each sub-chunk's keys by counting; the sorted sub-chunk keys go to
//      every CTA; barrier 1;
//   b. a key's place in the whole order is its rank in its sub-chunk plus,
//      for every other sub-chunk, a binary search of its keys (rows of an
//      earlier sub-chunk tie below, of a later one above); each CTA writes
//      its (key, row) pairs to their place in the CTA whose share of the
//      sorted positions holds them (and its successor, for the last of a
//      share); barrier 2;
//   c. each CTA marks its share of the sorted positions (a warp a run of
//      consecutive ones, each row read once, from the stash of the CTA
//      that holds it or from device memory) and sends the flags to every
//      CTA; barrier 3 (no CTA touches another's shared memory after it,
//      so none needs to wait for the others to leave);
//   d. every CTA scans all flags (16 a thread, warp shuffles) and writes
//      the inverse indices and new rows of its own rows (stash) or of its
//      share of the sorted positions.
// Above 8192 rows: keys and order in device memory, one launch per bitonic
// pass, then marks, tile sums, one scan of the tile sums and a scatter.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef unsigned long long u64;

#define MAX_COLS 9
#define CLUSTER_MAX_ROWS 8192  // the one-launch path
#define CLUSTER 16             // CTAs of the one-launch path's cluster (fewer for fewer sub-chunks)
#define SMEM_MAX (226 * 1024)  // dynamic shared memory a CTA may opt in to (H100: 227 KB, less the static)
#define SUB 128                // rows of a sub-chunk (one-launch path)
#define NT 512                 // threads a CTA
#define WARPS (NT / 32)
#define TILE (16 * NT)         // positions a CTA scans (16 a thread)
#define WPL 6                  // words of a row a lane loads at once from device memory
#define HASH_ROWS 4            // rows a warp hashes at once
#define FULL 0xffffffffu

struct DedupCol {
  const void* ptr;  // [>= n, width] int32 or bool, row-major
  int width;
  int offset;       // the column's first word in the packed row
  int is_bool;
};

struct DedupArgs {
  DedupCol cols[MAX_COLS];
  int ncols, n, C;
  unsigned* compact;  // [n, C]
  int* inv;           // [n]
  int* n_uniq;        // scalar
  void* scratch;      // dedup_rows_scratch_bytes(n) bytes (none up to CLUSTER_MAX_ROWS)
  long long* prof;    // one-launch path: clock64 at each phase mark of CTA 0, or null
};

// the path above CLUSTER_MAX_ROWS: its scratch, carved by the launcher
struct Scratch {
  u64* keys;             // [L]
  int* order;            // [L]
  unsigned char* flags;  // [L]
  int* tile_sum;         // [ceil(n / TILE)]
  int L;                 // n rounded up to a power of two (a multiple of TILE)
};

// ---------------------------------------------------------------------------
// rows read in place

// The column table in shared memory and the columns' offsets in registers
// (past ncols: INT_MAX). Every thread calls it; a __syncthreads must follow.
__device__ __forceinline__ void load_cols(const DedupArgs& a, DedupCol* sc, int (&off)[MAX_COLS]) {
#pragma unroll
  for (int k = 0; k < MAX_COLS; ++k) {
    if (threadIdx.x == k && k < a.ncols) sc[k] = a.cols[k];
    off[k] = k < a.ncols ? a.cols[k].offset : 0x7fffffff;
  }
}

// A lane's words of one chunk of the packed row, j = base + lane + 32 u,
// worked out once: reading word u of row i is then a multiply-add and one
// 4-byte load, and hashing it two multiply-adds
struct Slots {
  const unsigned char* p[WPL];  // word u of row 0 (a dead word, j >= C: word 0 of row 0, stride 0)
  unsigned stride[WPL];         // bytes a row
  unsigned m1[WPL], m2[WPL];    // the hashes' multipliers (2j+1) * 2654435761 and (2j+1) * 2246822519; 0 when dead
  unsigned byte;                // bit u: a bool column (a byte a word, widened to 0/1)
  unsigned live;                // bit u: j < C
  unsigned h2j;                 // the sum of j * m2 over the live words: the part of h2 no row changes
  int words;                    // slots with a live lane (warp-uniform)
};

// the last column whose offset is <= j holds word j (a column of width 0
// shares its offset with the next one)
__device__ __forceinline__ const DedupCol& col_of(const DedupCol* sc, const int (&off)[MAX_COLS], int j) {
  int c = 0;
#pragma unroll
  for (int k = 1; k < MAX_COLS; ++k) c += j >= off[k];
  return sc[c];
}

__device__ __forceinline__ void slots_at(const DedupCol* sc, const int (&off)[MAX_COLS], int C, int base, Slots& sl) {
  const int lane = threadIdx.x & 31;
  const DedupCol& c0 = col_of(sc, off, 0);
  sl.byte = sl.live = sl.h2j = 0u;
  sl.words = min(WPL, (C - base + 31) / 32);
#pragma unroll
  for (int u = 0; u < WPL; ++u) {
    const int j = base + lane + 32 * u;
    const bool live = j < C;
    const DedupCol& col = col_of(sc, off, j);
    const int esz = col.is_bool ? 1 : 4;
    const unsigned odd = 2u * (unsigned)j + 1u, m2 = odd * 2246822519u;
    sl.p[u] = live ? (const unsigned char*)col.ptr + (long long)(j - col.offset) * esz : (const unsigned char*)c0.ptr;
    sl.stride[u] = live ? (unsigned)(col.width * esz) : 0u;
    sl.m1[u] = live ? odd * 2654435761u : 0u;
    sl.m2[u] = live ? m2 : 0u;
    sl.h2j += live ? (unsigned)j * m2 : 0u;
    sl.byte |= (unsigned)(live && col.is_bool) << u;
    sl.live |= (unsigned)live << u;
  }
}

// Word u of row i (a column's bytes fit 32 bits: the wrapper checks). A
// bool is read as the aligned 4-byte word that holds its byte (torch's
// CUDA blocks are 512-byte aligned and sized, so that word lies inside the
// tensor's block), so every word is one load.
__device__ __forceinline__ unsigned slot_word(const Slots& sl, int u, int i) {
  const unsigned char* a = sl.p[u] + (unsigned)i * sl.stride[u];
  const unsigned w = __ldg((const unsigned*)((size_t)a & ~(size_t)3)) >> (8u * ((unsigned)(size_t)a & 3u));
  return (sl.byte >> u) & 1u ? (unsigned)((w & 0xffu) != 0u) : w;
}

// the chunk at `base`: s0 is the first chunk's (every row function takes
// it from its caller, which works it out once)
__device__ __forceinline__ Slots chunk_slots(const DedupCol* sc, const int (&off)[MAX_COLS], int C, int base,
                                             const Slots& s0) {
  if (base == 0) return s0;
  Slots sl;
  slots_at(sc, off, C, base, sl);
  return sl;
}

// The keys ((u64)h1 << 32 | h2) of R rows (valid row indices) by one warp,
// their words loaded WPL at a time a lane.
template <int R>
__device__ __forceinline__ void row_keys(const DedupCol* sc, const int (&off)[MAX_COLS], int C, const Slots& s0,
                                         const int (&rows)[R], u64 (&keys)[R]) {
  unsigned h1[R], h2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) h1[r] = h2[r] = 0u;
  for (int base = 0; base < C; base += 32 * WPL) {
    const Slots sl = chunk_slots(sc, off, C, base, s0);
    unsigned v[R][WPL];
#pragma unroll
    for (int u = 0; u < WPL; ++u)
      if (u < sl.words)
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][u] = slot_word(sl, u, rows[r]);
#pragma unroll
    for (int u = 0; u < WPL; ++u)
      if (u < sl.words)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          h1[r] += v[r][u] * sl.m1[u];
          h2[r] += v[r][u] * sl.m2[u];
        }
#pragma unroll
    for (int r = 0; r < R; ++r) h2[r] += sl.h2j;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      h1[r] += __shfl_xor_sync(FULL, h1[r], o);
      h2[r] += __shfl_xor_sync(FULL, h2[r], o);
    }
    keys[r] = ((u64)h1[r] << 32) | (u64)h2[r];
  }
}

// row i, widened, into dst[0, C), by one warp
__device__ __forceinline__ void copy_row(const DedupCol* sc, const int (&off)[MAX_COLS], int C, const Slots& s0, int i,
                                         unsigned* dst) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < C; base += 32 * WPL) {
    const Slots sl = chunk_slots(sc, off, C, base, s0);
    unsigned v[WPL];
#pragma unroll
    for (int u = 0; u < WPL; ++u)
      if (u < sl.words) v[u] = slot_word(sl, u, i);
#pragma unroll
    for (int u = 0; u < WPL; ++u)
      if (u < sl.words && (sl.live >> u) & 1u) dst[base + lane + 32 * u] = v[u];
  }
}

// zeroes words [w0, w1) of p, thread g of G (p 16-byte aligned)
__device__ __forceinline__ void zero_words(unsigned* p, long long w0, long long w1, long long g, long long G) {
  if (w0 >= w1) return;
  const long long a0 = min(w1, (w0 + 3) & ~3LL), a1 = max(a0, w1 & ~3LL);
  for (long long w = w0 + g; w < a0; w += G) p[w] = 0u;
  for (long long q = a0 / 4 + g; q < a1 / 4; q += G) ((uint4*)p)[q] = make_uint4(0u, 0u, 0u, 0u);
  for (long long w = a1 + g; w < w1; w += G) p[w] = 0u;
}

// ---------------------------------------------------------------------------
// scans

// The block's exclusive prefix sum of v, and its total (wtot: 33 ints).
// Holds two __syncthreads; the caller syncs again before reusing wtot.
__device__ __forceinline__ int block_exclusive(int v, int* wtot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? wtot[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += u;
    }
    if (lane < nw) wtot[lane] = wi - w;
    if (lane == 31) wtot[32] = wi;
  }
  __syncthreads();
  *total = wtot[32];
  return wtot[warp] + incl - v;
}

// the 0/1 bytes of a flag word set
__device__ __forceinline__ int popc4(uint4 f) { return __popc(f.x) + __popc(f.y) + __popc(f.z) + __popc(f.w); }
__device__ __forceinline__ int flag_at(uint4 f, int q) {
  const unsigned w = q < 4 ? f.x : q < 8 ? f.y : q < 12 ? f.z : f.w;
  return (w >> (8 * (q & 3))) & 1;
}

// ---------------------------------------------------------------------------
// the one-launch path (n <= CLUSTER_MAX_ROWS)

__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// The keys below `key` in the sorted sub-chunks q0, q0 + 4, q0 + 8 and
// q0 + 12 (those < SC, other than q): a binary search of each, the four
// interleaved. Rows of an earlier sub-chunk than q tie below the key.
__device__ __forceinline__ int count_below4(const u64* ckeys, int n, int SC, int q, int q0, u64 key) {
  int pos[4], cn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q2 = q0 + 4 * k;
    cn[k] = q2 < SC && q2 != q ? min(SUB, n - q2 * SUB) : 0;
    pos[k] = 0;
  }
#pragma unroll
  for (int step = SUB; step > 0; step >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = pos[k] + step <= cn[k];
      const u64 kk = ckeys[min((q0 + 4 * k) * SUB + pos[k] + step - 1, SC * SUB - 1)];
      pos[k] += in && (kk < key || (q0 + 4 * k < q && kk == key)) ? step : 0;
    }
  return pos[0] + pos[1] + pos[2] + pos[3];
}

// flags[p] of the consecutive sorted positions p in [s, e), by one warp:
// a row is new where its key differs from its predecessor's or, the keys
// equal, a word differs; four positions a step, each row read once
__device__ __forceinline__ void mark_run(const DedupCol* sc, const int (&off)[MAX_COLS], int C, const Slots& s0,
                                         const u64* skeys, const int* sorder, int s, int e, unsigned char* flags) {
  const int lane = threadIdx.x & 31;
  for (; s < e; s += 4) {
    bool differ[4], open = false;
    int row[5];  // row[0] precedes position s, row[k + 1] is at s + k (0: none needed)
    row[0] = s > 0 ? sorder[s - 1] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = s + k;
      differ[k] = p >= e || p == 0 || skeys[p] != skeys[p - 1];
      row[k + 1] = p < e ? sorder[p] : 0;
      open |= !differ[k];
    }
    for (int base = 0; base < C && open; base += 32 * WPL) {
      const Slots sl = chunk_slots(sc, off, C, base, s0);
      unsigned v[5][WPL];
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const bool need = (t > 0 && !differ[t - 1]) || (t < 4 && !differ[t]);  // warp-uniform
#pragma unroll
        for (int u = 0; u < WPL; ++u)
          if (u < sl.words) v[t][u] = need ? slot_word(sl, u, row[t]) : 0u;
      }
      open = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool d = false;
#pragma unroll
        for (int u = 0; u < WPL; ++u)
          if (u < sl.words) d |= v[k][u] != v[k + 1][u];
        differ[k] = differ[k] || __any_sync(FULL, d);
        open |= !differ[k];
      }
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s + k < e) flags[s + k] = differ[k];
  }
}

// ---------------------------------------------------------------------------
// the stash (one-launch path, where it fits): each CTA keeps its own rows
// in shared memory packed as the reference packs them, C u32 words a row,
// bools widened; the int words copied in by 16-byte cp.async. The CTA
// hashes them there, every CTA reads them there through distributed
// shared memory to compare rows, and each CTA copies its new rows from
// there. A word of a stashed row is one load at an immediate offset.

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// this CTA's own rows, slot s at stash + s * C (C <= 256, every width a
// multiple of 4, the columns 16-byte aligned: the launcher checks), a
// warp a row, a lane's two 4-word vectors j = 4 lane + 128 k worked out
// once; every copy is asynchronous, four bools landing in the first word
// of their vector and widened in place after
__device__ __forceinline__ void stash_fill(unsigned* stash, const DedupCol* sc, const int (&off)[MAX_COLS], int C, int n,
                                           int rank, int CS, int own) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* p[2];
  unsigned rs[2];
  bool live[2], bools[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = 4 * lane + 128 * k;
    live[k] = j < C;
    const DedupCol& col = col_of(sc, off, live[k] ? j : 0);
    const unsigned esz = col.is_bool ? 1u : 4u;
    p[k] = (const unsigned char*)col.ptr + (size_t)((live[k] ? j : 0) - col.offset) * esz;
    rs[k] = (unsigned)col.width * esz;
    bools[k] = col.is_bool;
  }
  for (int s = warp; s < own; s += WARPS) {
    const int i = (rank + (s / SUB) * CS) * SUB + s % SUB;
    if (i >= n) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      unsigned* dst = stash + (size_t)s * C + 4 * lane + 128 * k;
      const unsigned char* src = p[k] + (size_t)i * rs[k];
      if (live[k] && bools[k])
        copy4_async(dst, src);
      else if (live[k])
        copy16_async(dst, src);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int s = warp; s < own; s += WARPS) {
    if ((rank + (s / SUB) * CS) * SUB + s % SUB >= n) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (live[k] && bools[k]) {
        unsigned* w = stash + (size_t)s * C + 4 * lane + 128 * k;
        const unsigned b = *w;
        *(uint4*)w = make_uint4((b & 0xffu) != 0u, (b & 0xff00u) != 0u, (b & 0xff0000u) != 0u, (b >> 24) != 0u);
      }
  }
}

// A stashed row is read as 16-byte vectors, vector k of a lane holding
// the words j = 128 k + 4 lane + w (w < 4; C <= 256): the lane's hash
// multipliers of those words, 0 past C, and the sum of j * m2 over them
// (Slots' fields)
#define SVEC 2
struct StashSlots {
  unsigned m1[4 * SVEC], m2[4 * SVEC];
  unsigned h2j;
};

__device__ __forceinline__ void stash_slots(int C, StashSlots& sl) {
  const int lane = threadIdx.x & 31;
  sl.h2j = 0u;
#pragma unroll
  for (int u = 0; u < 4 * SVEC; ++u) {
    const unsigned j = (unsigned)(128 * (u / 4) + 4 * lane + u % 4), odd = 2u * j + 1u, m2 = odd * 2246822519u;
    const bool live = j < (unsigned)C;
    sl.m1[u] = live ? odd * 2654435761u : 0u;
    sl.m2[u] = live ? m2 : 0u;
    sl.h2j += live ? j * m2 : 0u;
  }
}

// vector k of a lane of the stashed row at `row` (zeros past C)
__device__ __forceinline__ uint4 stash_vec(const unsigned* row, int C, int k) {
  const int j = 128 * k + 4 * (threadIdx.x & 31);
  return j < C ? *(const uint4*)(row + j) : make_uint4(0u, 0u, 0u, 0u);
}

// row_keys on stashed rows (this CTA's)
template <int R>
__device__ __forceinline__ void stash_keys(const StashSlots& sl, int C, const unsigned* const (&row)[R], u64 (&keys)[R]) {
  uint4 v[R][SVEC];
#pragma unroll
  for (int k = 0; k < SVEC; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r) v[r][k] = stash_vec(row[r], C, k);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    unsigned h1 = 0u, h2 = sl.h2j;
#pragma unroll
    for (int k = 0; k < SVEC; ++k) {
      const unsigned w[4] = {v[r][k].x, v[r][k].y, v[r][k].z, v[r][k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h1 += w[q] * sl.m1[4 * k + q];
        h2 += w[q] * sl.m2[4 * k + q];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      h1 += __shfl_xor_sync(FULL, h1, o);
      h2 += __shfl_xor_sync(FULL, h2, o);
    }
    keys[r] = ((u64)h1 << 32) | (u64)h2;
  }
}

// mark_run on stashed rows: row r is row r % SUB of sub-chunk q = r / SUB,
// stashed by CTA q % CS at its slot (q / CS) * SUB + r % SUB
__device__ __forceinline__ void mark_run_stash(unsigned* stash, int C, int CS, const u64* skeys, const int* sorder,
                                               int s, int e, unsigned char* flags) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  for (; s < e; s += 4) {
    bool differ[4], open = false;
    int row[5];  // row[0] precedes position s, row[k + 1] is at s + k (0: none needed)
    row[0] = s > 0 ? sorder[s - 1] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = s + k;
      differ[k] = p >= e || p == 0 || skeys[p] != skeys[p - 1];
      row[k + 1] = p < e ? sorder[p] : 0;
      open |= !differ[k];
    }
    if (open) {
      uint4 v[5][SVEC];
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const bool need = (t > 0 && !differ[t - 1]) || (t < 4 && !differ[t]);  // warp-uniform
        const int q = row[t] / SUB;
        const unsigned* src = cluster.map_shared_rank(stash, q % CS) + (size_t)((q / CS) * SUB + row[t] % SUB) * C;
#pragma unroll
        for (int k = 0; k < SVEC; ++k) v[t][k] = need ? stash_vec(src, C, k) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool d = false;
#pragma unroll
        for (int x = 0; x < SVEC; ++x)
          d |= v[k][x].x != v[k + 1][x].x || v[k][x].y != v[k + 1][x].y || v[k][x].z != v[k + 1][x].z ||
               v[k][x].w != v[k + 1][x].w;
        differ[k] = differ[k] || __any_sync(FULL, d);
      }
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s + k < e) flags[s + k] = differ[k];
  }
}

// compact's zeros by the tensor memory accelerator: bulk copies of a
// zeroed shared buffer over this CTA's 16-byte aligned slice of [b0, b1),
// started by lane 0 of each warp, which waits for them before barrier 3
// (the unique rows overwrite theirs after it)
#define ZERO_BYTES 4096

__device__ __forceinline__ void bulk_zero(unsigned* compact, size_t b0, size_t b1, const unsigned char* zeros) {
  if ((threadIdx.x & 31) != 0) return;
  const unsigned z = (unsigned)__cvta_generic_to_shared(zeros);
  for (size_t b = b0 + (size_t)(threadIdx.x >> 5) * ZERO_BYTES; b < b1; b += (size_t)WARPS * ZERO_BYTES) {
    const unsigned len = (unsigned)min((size_t)ZERO_BYTES, b1 - b);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"((unsigned char*)compact + b), "r"(z),
                 "r"(len)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_zero_wait() {
  if ((threadIdx.x & 31) == 0) asm volatile("cp.async.bulk.wait_group 0;\n\tfence.proxy.async;\n" ::: "memory");
}

// Shared memory of one CTA: ckeys u64[NR] (sorted sub-chunk keys; then
// dest int[NR]), skeys u64[NR], okeys u64[OWN] (this CTA's keys), sorder
// int[NR], rank int[OWN], flags u8[NR], then with STASH the stash
// (u32[OWN][C]), then ZERO_BYTES of zeros; NR = n rounded up to SUB, OWN
// = SUB x the sub-chunks a CTA owns at most.
__host__ __device__ __forceinline__ int own_rows(int n, int cs) {
  const int sc = (n + SUB - 1) / SUB;
  return (sc + cs - 1) / cs * SUB;
}
__host__ __device__ __forceinline__ size_t cluster_smem(int n, int cs) {
  const int nr = (n + SUB - 1) / SUB * SUB;
  return (size_t)nr * (8 + 8 + 4 + 1) + (size_t)own_rows(n, cs) * (8 + 4);
}

#define MARK(k) \
  if (prof_on) prof[k] = clock64()

template <bool STASH>
__global__ void __launch_bounds__(NT, 1) dedup_cluster_kernel(const DedupArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ DedupCol sc[MAX_COLS];
  __shared__ int wtot[33];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, C = a.C;
  const int SC = (n + SUB - 1) / SUB, NR = SC * SUB, OWN = own_rows(n, CS);
  u64* ckeys = (u64*)smem;
  u64* skeys = ckeys + NR;
  u64* okeys = skeys + NR;
  int* sorder = (int*)(okeys + OWN);
  int* orank = sorder + NR;
  unsigned char* flags = (unsigned char*)(orank + OWN);
  unsigned* stash = (unsigned*)(smem + cluster_smem(n, CS));
  unsigned char* zeros = (unsigned char*)(stash + (STASH ? (size_t)OWN * C : 0));
  int* dest = (int*)ckeys;  // after barrier 3
  long long* prof = a.prof;
  const bool prof_on = prof != nullptr && rank == 0 && tid == 0;
  MARK(0);

  // matched by the wait before the first store to another CTA: by then
  // every CTA of the cluster has started
  cluster_arrive_relaxed();
  int off[MAX_COLS];
  load_cols(a, sc, off);
  for (int p = n + tid; p < NR; p += NT) flags[p] = 0;
  for (int s = tid; s < OWN; s += NT) orank[s] = 0;
  for (int t = tid; t < ZERO_BYTES / 16; t += NT) ((uint4*)zeros)[t] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, seen by the bulk copies
  __syncthreads();
  // this CTA's slice of compact's bytes (the last few past a 16-byte
  // boundary by ordinary stores), zeroed once its rows are read in
  const size_t zbytes = (size_t)n * C * 4, z16 = zbytes & ~(size_t)15;
  const size_t zper = ((z16 + CS - 1) / CS + 15) & ~(size_t)15, z0 = min(z16, (size_t)rank * zper);
  if (rank == CS - 1 && tid < (int)(zbytes - z16) / 4) a.compact[z16 / 4 + tid] = 0u;
  Slots s0;  // with STASH no row is read from device memory after the stash is filled
  if constexpr (!STASH) slots_at(sc, off, C, 0, s0);

  // own slot s = m * SUB + e holds row (rank + m * CS) * SUB + e
  auto row_of = [&](int s) -> int { return (rank + (s / SUB) * CS) * SUB + s % SUB; };

  // a. hash this CTA's rows, HASH_ROWS a warp at once (a slot past the
  // rows hashes some row, unstored)
  StashSlots ss;
  if constexpr (STASH) {
    stash_fill(stash, sc, off, C, n, rank, CS, OWN);
    __syncthreads();
    stash_slots(C, ss);
  }
  bulk_zero(a.compact, z0, min(z16, z0 + zper), zeros);
  MARK(1);
  for (int s = warp; s < OWN; s += HASH_ROWS * WARPS) {
    u64 k[HASH_ROWS];
    if constexpr (STASH) {
      const unsigned* rows[HASH_ROWS];
#pragma unroll
      for (int r = 0; r < HASH_ROWS; ++r) rows[r] = stash + (size_t)min(s + r * WARPS, OWN - 1) * C;
      stash_keys<HASH_ROWS>(ss, C, rows, k);
    } else {
      int rows[HASH_ROWS];
#pragma unroll
      for (int r = 0; r < HASH_ROWS; ++r) {
        const int sr = s + r * WARPS, i = sr < OWN ? row_of(sr) : n;
        rows[r] = i < n ? i : 0;
      }
      row_keys<HASH_ROWS>(sc, off, C, s0, rows, k);
    }
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < HASH_ROWS; ++r) {
        const int sr = s + r * WARPS;
        if (sr < OWN && row_of(sr) < n) okeys[sr] = k[r];
      }
  }
  __syncthreads();
  MARK(2);
  // rank each key in its sub-chunk: (slot, quarter) pairs, a quarter of
  // the sub-chunk's keys each (rows in order: the index breaks ties)
  for (int p = tid; p < 4 * OWN; p += NT) {
    const int part = p / OWN, s = p % OWN, e = s % SUB, sub0 = s - e;
    const int cnt = min(SUB, n - (rank + (s / SUB) * CS) * SUB);
    if (e < cnt) {
      const u64 ke = okeys[s];
      int c = 0;
#pragma unroll 8
      for (int j = part * (SUB / 4); j < (part + 1) * (SUB / 4); ++j) {
        const u64 kj = okeys[sub0 + j];  // past cnt: a slot of this sub-chunk, not counted
        c += j < cnt && (kj < ke || (kj == ke && j < e));
      }
      atomicAdd(&orank[s], c);
    }
  }
  __syncthreads();
  MARK(3);
  cluster_wait();
  for (int t = tid; t < OWN * CS; t += NT) {
    const int s = t % OWN, dst = t / OWN, i = row_of(s);
    if (i < n) cluster.map_shared_rank(ckeys, dst)[i - s % SUB + orank[s]] = okeys[s];
  }
  cluster_arrive();
  cluster_wait();  // barrier 1: every sorted sub-chunk everywhere
  MARK(4);

  // b. each key's place in the whole order
  for (int p = tid; p < 4 * OWN; p += NT) {
    const int part = p / OWN, s = p % OWN, q = rank + (s / SUB) * CS;
    if (q * SUB + s % SUB < n) {
      int c = 0;
      for (int q0 = part; q0 < SC; q0 += 16) c += count_below4(ckeys, n, SC, q, q0, okeys[s]);
      atomicAdd(&orank[s], c);
    }
  }
  __syncthreads();
  MARK(5);
  // each (key, row) pair to the CTA whose share of the sorted positions
  // holds it, and the last of a share also to the next CTA (its
  // predecessor)
  const int share = ((n + CS - 1) / CS + 15) & ~15;
  for (int s = tid; s < OWN; s += NT) {
    const int i = row_of(s);
    if (i < n) {
      const int g = orank[s], dst = g / share;
      cluster.map_shared_rank(skeys, dst)[g] = okeys[s];
      cluster.map_shared_rank(sorder, dst)[g] = i;
      if (g % share == share - 1 && dst + 1 < CS) {
        cluster.map_shared_rank(skeys, dst + 1)[g] = okeys[s];
        cluster.map_shared_rank(sorder, dst + 1)[g] = i;
      }
    }
  }
  cluster_arrive();
  cluster_wait();  // barrier 2: each share's sorted (key, row) pairs in place
  MARK(6);

  // c. mark this CTA's share of the sorted positions, a run of
  // consecutive ones a warp
  const int lo = min(n, rank * share), hi = min(n, lo + share);
  {
    const int per = ((hi - lo + WARPS - 1) / WARPS + 3) & ~3, ws = lo + warp * per;
    if constexpr (STASH)
      mark_run_stash(stash, C, CS, skeys, sorder, ws, min(hi, ws + per), flags);
    else
      mark_run(sc, off, C, s0, skeys, sorder, ws, min(hi, ws + per), flags);
  }
  __syncthreads();
  MARK(7);
  {
    const int w0 = lo / 4, nw = hi > lo ? (hi + 3) / 4 - w0 : 0;  // lo is a multiple of 16
    for (int t = tid; t < nw * CS; t += NT) {
      const int w = w0 + t % nw, dst = t / nw;
      if (dst != rank) cluster.map_shared_rank((unsigned*)flags, dst)[w] = ((const unsigned*)flags)[w];
    }
  }
  bulk_zero_wait();
  cluster_arrive();
  cluster_wait();  // barrier 3: every flag everywhere; no CTA reads or writes another's memory after it
  MARK(8);

  // d. scan all flags, then this CTA's share of the outputs
  const uint4 f = 16 * tid < NR ? ((const uint4*)flags)[tid] : make_uint4(0u, 0u, 0u, 0u);
  int total;
  int run = block_exclusive(popc4(f), wtot, &total);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    run += flag_at(f, q);
    if (16 * tid + q < n) dest[16 * tid + q] = run - 1;
  }
  __syncthreads();
  MARK(9);
  if constexpr (STASH) {
    // this CTA's own rows: their inverse indices, and those that are new
    // copied from the stash
    for (int s = tid; s < OWN; s += NT)
      if (row_of(s) < n) a.inv[row_of(s)] = dest[orank[s]];
    for (int s = warp; s < OWN; s += WARPS) {
      if (row_of(s) >= n || !flags[orank[s]]) continue;  // warp-uniform
      const unsigned* src = stash + (size_t)s * C;
      unsigned* dst = a.compact + (long long)dest[orank[s]] * C;  // 16-byte aligned: C % 4 == 0
#pragma unroll
      for (int k = 0; k < SVEC; ++k)
        if (128 * k + 4 * lane < C) *(uint4*)(dst + 128 * k + 4 * lane) = stash_vec(src, C, k);
    }
  } else {
    for (int s = lo + tid; s < hi; s += NT) a.inv[sorder[s]] = dest[s];
    for (int s = lo + warp; s < hi; s += WARPS)
      if (flags[s]) copy_row(sc, off, C, s0, sorder[s], a.compact + (long long)dest[s] * C);
  }
  if (rank == 0 && tid == 0) *a.n_uniq = total;
  MARK(10);
}

// ---------------------------------------------------------------------------
// the path above CLUSTER_MAX_ROWS

__global__ void hash_kernel(const DedupArgs a, const Scratch w) {
  __shared__ DedupCol sc[MAX_COLS];
  int off[MAX_COLS];
  load_cols(a, sc, off);
  __syncthreads();
  Slots s0;
  slots_at(sc, off, a.C, 0, s0);
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= w.L) return;
  const int rows[1] = {i < a.n ? i : 0};
  u64 k[1];
  row_keys<1>(sc, off, a.C, s0, rows, k);
  if ((threadIdx.x & 31) == 0) {
    w.keys[i] = i < a.n ? k[0] : ~0ull;  // padding sorts last (its index breaks ties)
    w.order[i] = i;
  }
}

__device__ __forceinline__ bool key_less(u64 ka, int ia, u64 kb, int ib) { return ka < kb || (ka == kb && ia < ib); }

// the compare-exchange of bitonic stage (k, j) at element i (< i ^ j)
__global__ void sort_pass_kernel(const Scratch w, int j, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w.L / 2) return;
  const int i = 2 * j * (t / j) + (t % j), l = i ^ j;
  const bool up = (i & k) == 0;
  const u64 ki = w.keys[i], kl = w.keys[l];
  const int ii = w.order[i], il = w.order[l];
  if (key_less(kl, il, ki, ii) == up) {
    w.keys[i] = kl;
    w.keys[l] = ki;
    w.order[i] = il;
    w.order[l] = ii;
  }
}

// flags[s] for every sorted position s < L (0 past n), a warp each
__global__ void mark_kernel(const DedupArgs a, const Scratch w) {
  __shared__ DedupCol sc[MAX_COLS];
  int off[MAX_COLS];
  load_cols(a, sc, off);
  __syncthreads();
  Slots s0;
  slots_at(sc, off, a.C, 0, s0);
  const int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (s >= w.L) return;
  if (s < a.n)
    mark_run(sc, off, a.C, s0, w.keys, w.order, s, s + 1, w.flags);
  else if ((threadIdx.x & 31) == 0)
    w.flags[s] = 0;
}

__global__ void __launch_bounds__(NT) tile_sum_kernel(const Scratch w) {
  __shared__ int wtot[33];
  const uint4 f = ((const uint4*)w.flags)[(long long)blockIdx.x * NT + threadIdx.x];
  int total;
  block_exclusive(popc4(f), wtot, &total);
  if (threadIdx.x == 0) w.tile_sum[blockIdx.x] = total;
}

// tile sums -> exclusive offsets, and n_uniq (one CTA of 1024)
__global__ void __launch_bounds__(1024) tile_scan_kernel(const DedupArgs a, const Scratch w, int tiles) {
  __shared__ int wtot[33];
  int carry = 0;
  for (int base = 0; base < tiles; base += 1024) {
    const int t = base + threadIdx.x;
    int total;
    const int ex = block_exclusive(t < tiles ? w.tile_sum[t] : 0, wtot, &total);
    if (t < tiles) w.tile_sum[t] = carry + ex;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *a.n_uniq = carry;
}

__global__ void __launch_bounds__(NT) scatter_kernel(const DedupArgs a, const Scratch w) {
  __shared__ DedupCol sc[MAX_COLS];
  __shared__ int sdest[TILE];
  __shared__ int wtot[33];
  int off[MAX_COLS];
  load_cols(a, sc, off);
  const int tid = threadIdx.x, n = a.n;
  const int t0 = blockIdx.x * TILE, p0 = t0 + 16 * tid;
  const uint4 f = ((const uint4*)w.flags)[p0 / 16];
  int total;
  int run = w.tile_sum[blockIdx.x] + block_exclusive(popc4(f), wtot, &total);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int b = flag_at(f, q);
    run += b;
    if (p0 + q < n) {
      a.inv[w.order[p0 + q]] = run - 1;
      sdest[16 * tid + q] = b ? run - 1 : -1;
    }
  }
  __syncthreads();
  Slots s0;
  slots_at(sc, off, a.C, 0, s0);
  const int hi = min(n, t0 + TILE);
  for (int s = t0 + (tid >> 5); s < hi; s += WARPS)
    if (sdest[s - t0] >= 0) copy_row(sc, off, a.C, s0, w.order[s], a.compact + (long long)sdest[s - t0] * a.C);
  const int nu = *a.n_uniq;
  zero_words(a.compact, (long long)max(nu, t0) * a.C, (long long)hi * a.C, tid, NT);
}

// ---------------------------------------------------------------------------
// launch

extern "C" int dedup_rows_args_size() { return (int)sizeof(DedupArgs); }

template <bool STASH>
static cudaError_t launch_cluster_as(const DedupArgs& a, int cs, size_t bytes, cudaStream_t s) {
  cudaError_t err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(dedup_cluster_kernel<STASH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  if (cs > 8) {
    err = cudaFuncSetAttribute(dedup_cluster_kernel<STASH>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dedup_cluster_kernel<STASH>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The stash is taken where it fits the CTA's shared memory and its
// copies are 16-byte aligned: a row of at most 128 SVEC words, every
// column's width a multiple of 4 and its data 16-byte aligned.
static int launch_cluster(const DedupArgs& a, cudaStream_t s) {
  const int cs = min(CLUSTER, (a.n + SUB - 1) / SUB);
  const size_t bytes = cluster_smem(a.n, cs) + ZERO_BYTES, with_stash = bytes + (size_t)own_rows(a.n, cs) * a.C * 4;
  bool stash = a.C <= 128 * SVEC && with_stash <= SMEM_MAX;
  for (int k = 0; k < a.ncols; ++k) stash = stash && a.cols[k].width % 4 == 0 && (size_t)a.cols[k].ptr % 16 == 0;
  return (int)(stash ? launch_cluster_as<true>(a, cs, with_stash, s) : launch_cluster_as<false>(a, cs, bytes, s));
}

static int scratch_L(int n) {
  int L = TILE;
  while (L < n) L <<= 1;
  return L;
}

extern "C" size_t dedup_rows_scratch_bytes(int n) {
  if (n <= CLUSTER_MAX_ROWS) return 0;
  const size_t L = (size_t)scratch_L(n);
  return 13 * L + 4 * (size_t)((n + TILE - 1) / TILE);  // keys, order, flags, tile sums
}

static int launch_passes(const DedupArgs& a, cudaStream_t s) {
  if (!a.scratch) return (int)cudaErrorInvalidValue;
  Scratch w;
  w.L = scratch_L(a.n);
  w.keys = (u64*)a.scratch;
  w.order = (int*)(w.keys + w.L);
  w.flags = (unsigned char*)(w.order + w.L);
  w.tile_sum = (int*)(w.flags + w.L);
  const int warp_blocks = w.L / 8;  // a warp a row or position, 8 warps a block
  hash_kernel<<<warp_blocks, 256, 0, s>>>(a, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (w.L / 2 + 255) / 256;
  for (int k = 2; k <= w.L; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) sort_pass_kernel<<<blocks, 256, 0, s>>>(w, j, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.n + TILE - 1) / TILE;
  mark_kernel<<<warp_blocks, 256, 0, s>>>(a, w);
  tile_sum_kernel<<<tiles, NT, 0, s>>>(w);
  tile_scan_kernel<<<1, 1024, 0, s>>>(a, w, tiles);
  scatter_kernel<<<tiles, NT, 0, s>>>(a, w);
  return (int)cudaGetLastError();
}

extern "C" int dedup_rows_launch(const DedupArgs* args, void* stream) {
  const DedupArgs a = *args;
  if (a.n <= 0 || a.ncols < 1 || a.ncols > MAX_COLS || a.C < 0) return (int)cudaErrorInvalidValue;
  return a.n <= CLUSTER_MAX_ROWS ? launch_cluster(a, (cudaStream_t)stream) : launch_passes(a, (cudaStream_t)stream);
}
