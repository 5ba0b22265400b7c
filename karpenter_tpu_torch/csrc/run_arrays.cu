// K4 run_arrays: the run driver arrays of a requeue round.
//
// Replaces karpenter_tpu/solver/tpu.py:155 `_run_arrays`: from the round's
// pod index array and the per-class flags, is_head (first pod of its class
// run; padding positions are all heads), bulk and aff (the class flags,
// off for padding) and run_rem (pods from i to the end of its run: the next
// head strictly after i, or P, minus i — the reference's reverse cummin).
//
// Bound on an H100: bytes (a few [P] arrays, tens of KB at the headline's
// P = 16384), so the launch's latency decides: the dependent trips to
// memory and the barriers.
//
// Design: one CTA of NT threads, consecutive threads on consecutive
// positions, so that every load and store of a warp is coalesced. The
// round is walked in tiles of NT * U positions from the last to the first,
// carrying the first head at or past the tile's end, so that the shared
// memory is the same for every P (a tile's bit words and next[], and the
// class flags up to FLAGS_SMEM classes; past that they are read from
// device memory).
//   0. The per-class flags, bulk | aff << 1, go to shared memory; their
//      loads fly while the last tile gathers.
//   1. Each thread gathers the class of U positions of the tile at once
//      (idx, then cls: U independent chains in flight), gets its
//      predecessor's class with __shfl_up_sync (lane 0, at the warp's edge,
//      gathers position i - 1's itself beside its own: no barrier), writes
//      is_head, bulk and aff, and the warp's 32 head flags become one bit
//      word in shared memory (__ballot_sync).
//   2. next[q], the first head after the tile's word q: a block-wide
//      reverse min-scan over the words' first heads, each warp's in
//      log2(32) shuffle steps, then one warp over the 32 warp totals, then
//      the carry from the later tiles.
//   3. run_rem[i] from the bit words alone: the next head inside i's word
//      (__ffs of the bits above i), else next[q].
// is_head is never read back from device memory, and nothing walks a
// sequence serially.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NT 1024
#define U 16                    // positions a thread gathers at once
#define TILE (NT * U)           // positions a tile
#define TILE_WORDS (TILE / 32)  // a tile's head bit words
#define FLAGS_SMEM 32768        // class flags staged in shared memory up to this many classes

struct RunArraysArgs {
  const int* cls;         // [NCLS] class of each pod
  const uint8_t* bulk_c;  // [NC]
  const uint8_t* aff_c;   // [NC]
  const int* idx;         // [P] pod of each position
  int* out;               // run_rem [P] int32, then is_head, bulk, aff [P] bytes each
  int P, n, NCLS, NC;
};

__device__ __forceinline__ int class_at(const RunArraysArgs& a, int i) {
  const int pod = min(max(__ldg(a.idx + i), 0), a.NCLS - 1);
  return min(max(__ldg(a.cls + pod), 0), a.NC - 1);
}

__device__ __forceinline__ int flag_of(const RunArraysArgs& a, int c) {
  return (__ldg(a.bulk_c + c) ? 1 : 0) | (__ldg(a.aff_c + c) ? 2 : 0);
}

// inclusive minimum over lanes lane..31 of the warp
__device__ __forceinline__ int suffix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  return v;
}

// Dynamic shared memory: the class flags, where they are staged.
__host__ __device__ inline size_t run_arrays_smem(int NC) { return NC <= FLAGS_SMEM ? (size_t)NC : 0; }

__global__ void __launch_bounds__(NT, 1) run_arrays_kernel(const RunArraysArgs a) {
  extern __shared__ uint8_t flags[];  // [NC] where NC <= FLAGS_SMEM
  __shared__ unsigned bits[TILE_WORDS];
  __shared__ int next[TILE_WORDS], warp_min[NT / 32], after_warp[NT / 32], carry_next;
  const int P = a.P;
  const bool staged = a.NC <= FLAGS_SMEM;
  int* run_rem = a.out;
  uint8_t* is_head = (uint8_t*)(a.out + P);
  uint8_t* bulk = is_head + P;
  uint8_t* aff = bulk + P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 0. the class flags: a thread's first one is loaded here and stored
  // once the last tile's gathers are in flight (classes past NT right away)
  const int flag0 = staged && tid < a.NC ? flag_of(a, tid) : 0;
  if (staged)
    for (int c = tid + NT; c < a.NC; c += NT) flags[c] = (uint8_t)flag_of(a, c);

  const int last = (P - 1) / TILE;
  int carry = P;  // the first head at or past the current tile's end (P: none)
  for (int t = last; t >= 0; --t) {
    const int base = t * TILE, end = min(base + TILE, P);

    // 1. classes, head flags and the class flags; the heads as bit words
    int c[U], prev[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(base + u * NT + tid, P - 1);
      c[u] = class_at(a, i);
      prev[u] = lane == 0 && i > 0 ? class_at(a, i - 1) : 0;
    }
    if (t == last && staged && tid < a.NC) flags[tid] = (uint8_t)flag0;
    __syncthreads();  // the flags are staged; the later tile is done with bits and next
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT + tid;
      const int up = __shfl_up_sync(0xffffffffu, c[u], 1);
      const bool valid = i < a.n;
      const bool head = i < P && (i == 0 || !valid || c[u] != (lane ? up : prev[u]));
      const unsigned word = __ballot_sync(0xffffffffu, head);
      if (i < P) {
        const int f = valid ? (staged ? flags[c[u]] : flag_of(a, c[u])) : 0;
        is_head[i] = head;
        bulk[i] = f & 1;
        aff[i] = f >> 1;
        if (lane == 0) bits[(i - base) >> 5] = word;  // a warp's positions fill one aligned word
      }
    }
    __syncthreads();

    // 2. next[q]: the first head after word q (carry: none in this tile)
    const int nw = (end - base + 31) >> 5;
    const int q = tid;
    const int first = q < nw && bits[q] ? base + (q << 5) + __ffs(bits[q]) - 1 : INT_MAX;
    const int s = suffix_min(first, lane);
    if (lane == 0) warp_min[warp] = s;
    __syncthreads();
    if (warp == 0) {
      const int ts = suffix_min(warp_min[lane], lane);
      const int ex = __shfl_down_sync(0xffffffffu, ts, 1);
      after_warp[lane] = min(lane == 31 ? INT_MAX : ex, carry);
      if (lane == 0) carry_next = min(ts, carry);
    }
    __syncthreads();
    const int nx = __shfl_down_sync(0xffffffffu, s, 1);
    if (q < nw) next[q] = min(lane == 31 ? INT_MAX : nx, after_warp[warp]);
    carry = carry_next;
    __syncthreads();

    // 3. run_rem: the next head strictly after i, or P
    for (int i = base + tid; i < end; i += NT) {
      const int w = (i - base) >> 5, b = i & 31;
      const unsigned above = b == 31 ? 0u : bits[w] >> (b + 1);
      run_rem[i] = (above ? i + __ffs(above) : next[w]) - i;
    }
  }
}

extern "C" int run_arrays_args_size() { return (int)sizeof(RunArraysArgs); }

extern "C" int run_arrays_launch(const RunArraysArgs* args, void* stream) {
  const RunArraysArgs a = *args;
  if (a.P <= 0) return 0;
  if (a.NCLS < 1 || a.NC < 1) return (int)cudaErrorInvalidValue;
  run_arrays_kernel<<<1, NT, run_arrays_smem(a.NC), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
