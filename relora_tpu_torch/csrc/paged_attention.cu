// Paged attention straight out of the KV page pool, for sm_90a.
//
//   paged_decode_kernel +  replace relora_tpu/ops/attention.py:244
//   paged_combine_kernel   _paged_decode_kernel (paged_decode_attention, :331):
//                          small-S decode/verify attention, q (B, S, N, H),
//                          S <= 16 in the serving path.
//   packed_tile_kernel +   replace relora_tpu/ops/attention.py:447
//   kernel 1's pair        _packed_paged_kernel (packed_paged_attention, :532):
//                          the same per packed token, q (1, T, N, H), with
//                          row_map (T,) picking each token's block-table row.
//
// Both compute, per query row and kv head, the g*S queries of the kv-head
// group (g = N / n_kv; S = 1 for packed tokens) against the row's pages,
// head-major (query qi = h*S + s is token s of head j*g + h), as the TPU kernel
// lays them out.  On the TPU the grid walks the W pages of a row in order and
// carries the online-softmax state (m, l, acc) across grid steps; Hopper runs
// blocks in no order.  Masked logits are -1e30 and p is masked too, not only
// the logits; the final division is guarded by max(l, 1e-30), so a query
// with no visible key (a pad row) gets 0, finite.  A fully masked key adds
// exactly 0 to the online softmax (m unchanged, alpha = 1, p = 0), so the
// walk stops after the last key any query of the row can see.
//
// Bound.  Memory-bound: the work per K/V byte is 2 flops per query of the
// group, far below the H100's ~295 flops/byte balance point, so for a decode
// row the tensor cores are no lever (a prefill tile's queries share every
// K/V byte, which is where kernel 2 uses them).  The least time is the bytes
// of the visible K/V rows
// (plus q, out, tables) over 3.35 TB/s: at llama_250m decode (B = 8, 16 kv
// heads, H = 48, ~500 visible keys a row) about 13 MB, ~4 us.  What keeps a
// kernel from it is the parallelism and latency of the page walk.
//
// Kernel 1: split over the page walk (split-KV), two launches.
//   1. paged_decode_kernel: one 128-thread block per (partition, query
//      chunk, kv head, row).  A row's table is cut into partitions of pp
//      pages; pp comes from (W, ps) alone (ops/attention.paged_decode_schedule),
//      never from the batch, so a row's result does not depend on the rows
//      it decodes with.
//      A partition past the row's last visible key returns at once.  Inside,
//      each warp takes a round of 32 keys, one a lane, rounds dealt to the
//      warps in turn: there is no block barrier in the walk.  A lane stages
//      its key's K and V rows into the warp's shared-memory tiles with 16-byte
//      cp.async, both in flight at once (the latency of the scattered rows is
//      paid once a round, not once a key), then dots its K row with the
//      block's queries (f32, in shared memory, read as broadcasts): bf16
//      widened as pairs, int8 codes widened in registers, and an int8 page's
//      (page, kv head) scale multiplies the f32 dot, not each element.  The
//      round's online-softmax update is f32 per warp, max and sum by
//      shuffles; each key's probabilities (times its V scale) go to a small
//      table in shared memory.  Then the lanes turn to head dims (two a lane,
//      pairs 64 apart) and walk the staged V rows key by key, conflict-free.
//      Rows past 256 bytes (f32 pools past H = 64) stage fewer keys a round,
//      so the tiles stay within 96 KB a block.  The warps' (m, l, acc) merge
//      once, in warp order, through shared memory, into an f32 partial (m, l,
//      acc) per (row, kv head, partition, query) in a scratch the wrapper
//      allocates.  A block
//      takes a chunk of QC of the group's queries (1, 4 or 8) and a lane NP =
//      ceil(H / 64) head-dim pairs, both template parameters, so registers
//      hold 2 QC NP accumulators and shared memory does not grow with g*S; a
//      group past QC queries has a block per chunk, each reading the
//      partition's K/V (the later ones mostly from L2).
//   2. paged_combine_kernel, a programmatic dependent launch (PDL) of the
//      first: one block per (kv head, row) merges the row's walked
//      partitions in partition order and writes out in q's dtype.  It reads
//      the positions before griddepcontrol.wait (inputs), the partials after.
// Rows whose positions are all -1 walk nothing and get 0.  The pools may be
// any H <= 256; H whose rows are no whole number of 16-byte vectors (or
// unaligned pools) are staged element by element on the same schedule.
//
// Kernel 2: a packed window mixes decode tokens (one a row), verify windows
// and prefill chunks (many consecutive tokens of one row, which share that
// row's pages).  Runs, maximal stretches of one row's tokens at consecutive
// positions, are found on the device from row_map and the positions (no host
// read), and cut into query tiles at positions that are multiples of qt =
// 64 / g tokens, so a token's tile follows from its own run alone.
//   1. packed_tile_kernel takes every tile of two tokens or more (bf16 q over
//      a bf16 or int8 pool, H a multiple of 8): one 4-warp block per (tile,
//      kv head) holds the tile's tokens x heads as a 64-row query tile and
//      walks the row's keys up to its last position in tiles of 64 (32 past
//      a padded head of 128) as flash attention's forward does: S = Q K^T and
//      P V by mma.sync m16n8k16 (bf16 in, f32 accumulate), K and V rows
//      gathered from their pages by cp.async into two buffers, int8 codes
//      widened to bf16 in shared memory, an int8 page's scales on the f32
//      scores and on P, the causal mask inside the run.  Each key tile is
//      read once for the whole query tile, not once a token.  A block whose
//      token starts no such tile returns at once (the grid is T x n_kv).
//   2. every other token (decode rows, pads, tiles of one token, and every
//      token of an f32 call or of a pool whose rows are not whole 8-element
//      vectors) goes through kernel 1's split pair as a row of one query
//      with its own table row (row_map): lanes over keys, rows staged by
//      cp.async, partitions from (W, ps) merged in order.  The partitions
//      are 512 keys here (ops/attention.packed_walk_schedule), not kernel
//      1's 128: every token of the window has its blocks, and the tokens of
//      multi-token tiles return at once, so four times fewer blocks return
//      for nothing.  The walk is a programmatic dependent launch of the tile
//      kernel (their outputs are disjoint, and the walk reads only inputs),
//      so the two run side by side; one of its blocks waits for the tiles,
//      so the pair still ends after them.
// Either way a token's path and the order of its sums come from its own run
// and its row's table: its output is bit for bit the same whatever else
// shares the window, and a key tile that a row of a tile cannot see adds
// exactly 0 (m unchanged, alpha = 1, p = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Kernel 1: split over the page walk (design in the header note)
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kMaxPairs = 4;             // head-dim pairs a lane accumulates at most: H <= 256
constexpr int kTileBudget = 96 * 1024;   // bytes of K/V rows a block stages at once, at most
constexpr unsigned kAll = 0xffffffffu;

struct SplitArgs {
  const void* q;         // (B, S, N, H) in TQ
  const void* pool_k;    // (P, ps, n_kv, H) in TKV
  const void* pool_v;
  const int32_t* bt;     // (B, W) block tables; packed: (rows, W)
  const int32_t* pos;    // (B, S) absolute positions
  const int32_t* row_map;  // packed (kernel 2): (B,) table row of each token, B = T, S = 1;
                           // null for kernel 1 (row = b)
  const float* k_scale;  // (P, n_kv) or null (unquantised)
  const float* v_scale;
  float* part;           // partials: (B, n_kv, n_part, G) x (m, l), then
                         // (B, n_kv, n_part, G, H) acc, f32
  void* out;             // (B, S, N, H) in TQ
  int B, S, N, n_kv, H, W, ps;
  int pp, n_part;        // pages per partition, partitions per row
  float sm_scale;
  int vec;               // 1: rows staged with 16-byte cp.async, else element by element
  int kpr;               // keys a warp stages a round (32, fewer for rows past 256 bytes)
  int stride;            // bytes between staged rows: an odd multiple of 16
  int qt;                // packed: tokens a query tile of the tensor-core kernel spans at
                         // most (packed_tile_kernel), 0 when it does not run
};

// The packed window's tiles (kernel 2).  A run is a maximal stretch of
// tokens of one table row at consecutive positions (a prefill chunk; a
// decode token or a pad is a run of one).  A run is cut into query tiles at
// positions that are multiples of qt, so a token's tile, and with it the
// kernel that takes it and the order of its sums, depends on its own run and
// position alone, never on what else shares the window
// (ops/attention.packed_tile_schedule is the same rule in Python).
__device__ __forceinline__ bool run_start(const int32_t* rm, const int32_t* pos, int t) {
  return t == 0 || rm[t] != rm[t - 1] || pos[t] != pos[t - 1] + 1;
}
__device__ __forceinline__ bool tile_start(const int32_t* rm, const int32_t* pos, int t, int qt) {
  return run_start(rm, pos, t) || pos[t] % qt == 0;
}
// token t lies in a tile of two tokens or more: packed_tile_kernel takes it,
// and kernel 1's pair skips it
__device__ __forceinline__ bool in_multi_tile(const int32_t* rm, const int32_t* pos, int T, int t,
                                              int qt) {
  if (qt < 2) return false;
  return !tile_start(rm, pos, t, qt) || (t + 1 < T && !tile_start(rm, pos, t + 1, qt));
}

// keys any query of a row can see: positions 0 .. max_s pos[s] of its S
// positions, cut to the table's W * ps keys; 0 for a row whose positions are
// all -1.  The lanes of a whole warp read the positions together
__device__ __forceinline__ int row_walk(const int32_t* pos, int S, int keys, int lane) {
  int mx = -1;
  for (int s = lane; s < S; s += 32) mx = max(mx, pos[s]);
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(kAll, mx, o));
  return min(keys, mx + 1);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// a 16-byte vector of T widened to f32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void widen(const uint4& v, float (&o)[n]) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void widen(const uint4& v, float (&o)[n]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_lo(w[i]);
      o[2 * i + 1] = bf16_hi(w[i]);
    }
  }
};
template <>
struct Vec16<int8_t> {
  static constexpr int n = 16;
  __device__ static void widen(const uint4& v, float (&o)[n]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) o[4 * i + b] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
  }
};

// elements d and d + 1 of a staged row as f32 (the row's padding makes d + 1
// readable when d is its last element)
__device__ __forceinline__ float2 row_pair(const float* r, int d) {
  return *reinterpret_cast<const float2*>(r + d);
}
__device__ __forceinline__ float2 row_pair(const __nv_bfloat16* r, int d) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(r + d);
  return make_float2(bf16_lo(u), bf16_hi(u));
}
__device__ __forceinline__ float2 row_pair(const int8_t* r, int d) {
  const char2 c = *reinterpret_cast<const char2*>(r + d);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// one key's row of H elements into shared memory: 16-byte cp.async when the
// rows are whole, aligned vectors (completed by the round's cp.async wait),
// else element by element
template <typename TKV>
__device__ __forceinline__ void stage_row(unsigned char* dst, const TKV* src, int H, bool vec) {
  if (vec) {
    for (int b = 0; b < H * (int)sizeof(TKV); b += 16)
      cp_async16(dst + b, reinterpret_cast<const unsigned char*>(src) + b);
  } else {
    for (int d = 0; d < H; ++d) reinterpret_cast<TKV*>(dst)[d] = src[d];
  }
}

// s[qi] = q[qi] . k over the H elements of one staged key row, for the QC
// queries of the chunk in shared memory (qs, rows of H f32)
template <typename TKV, int QC>
__device__ __forceinline__ void dot_row(const unsigned char* krow, const float* qs, int H, bool vec,
                                        float (&s)[QC]) {
  const TKV* k = reinterpret_cast<const TKV*>(krow);
  if (vec) {  // H * sizeof(TKV) is a multiple of 16, so H of 4 and qs rows are float4-aligned
    constexpr int n = Vec16<TKV>::n;
    for (int c = 0; c < H; c += n) {
      float kf[n];
      Vec16<TKV>::widen(*reinterpret_cast<const uint4*>(k + c), kf);
#pragma unroll
      for (int qi = 0; qi < QC; ++qi)
#pragma unroll
        for (int e = 0; e < n; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qs + qi * H + c + e);
          s[qi] = fmaf(q4.x, kf[e], s[qi]);
          s[qi] = fmaf(q4.y, kf[e + 1], s[qi]);
          s[qi] = fmaf(q4.z, kf[e + 2], s[qi]);
          s[qi] = fmaf(q4.w, kf[e + 3], s[qi]);
        }
    }
  } else {
    for (int d = 0; d < H; ++d) {
      const float kd = to_f32(k[d]);
#pragma unroll
      for (int qi = 0; qi < QC; ++qi) s[qi] = fmaf(qs[qi * H + d], kd, s[qi]);
    }
  }
}

// the first launch's shared memory: the chunk's queries (QC, H), each warp's
// acc (warps, QC, H), m and l (warps, QC) and probabilities (warps, 32, QC),
// all f32, then each warp's staged K rows and V rows (kpr rows each)
struct SplitSmem {
  float *qs, *wacc, *wm, *wl, *pt;
  unsigned char* tiles;
};
__host__ __device__ inline size_t split_floats(int QC, int H) {
  return ((size_t)QC * H * (1 + kSplitWarps) + (2 + 32) * kSplitWarps * QC + 3) / 4 * 4;
}
size_t split_smem_bytes(int QC, int H, int kpr, int stride) {
  return sizeof(float) * split_floats(QC, H) + (size_t)kSplitWarps * 2 * kpr * stride;
}
template <int QC>
__device__ __forceinline__ SplitSmem split_smem(int H) {
  extern __shared__ __align__(16) float smem_split[];
  SplitSmem m;
  m.qs = smem_split;
  m.wacc = m.qs + QC * H;
  m.wm = m.wacc + kSplitWarps * QC * H;
  m.wl = m.wm + kSplitWarps * QC;
  m.pt = m.wl + kSplitWarps * QC;
  m.tiles = reinterpret_cast<unsigned char*>(smem_split + split_floats(QC, H));
  return m;
}

// the thread's and the block's indices read anew from the special registers:
// what the merge derives from them is recomputed after the walk rather than
// held across it (ptxas otherwise parks such values in local memory)
struct BlockIds {
  int tid, x, j, r;  // blockIdx.x: partition * chunks + query chunk
};
__device__ __forceinline__ BlockIds fresh_ids() {
  BlockIds b;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(b.tid));
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(b.x));
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(b.j));
  asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(b.r));
  return b;
}

// the warp's (m, l, acc) of the chunk's queries into shared memory
template <int QC, int NP>
__device__ __forceinline__ void stash_warp(const SplitArgs& a, const float (&m)[QC],
                                           const float (&l)[QC], const float (&acc)[QC][NP][2]) {
  const BlockIds id = fresh_ids();
  const int H = a.H, warp = id.tid / 32, lane = id.tid % 32;
  const SplitSmem sm = split_smem<QC>(H);
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
    if (lane == 0) {
      sm.wm[warp * QC + qi] = m[qi];
      sm.wl[warp * QC + qi] = l[qi];
    }
    float* dst = sm.wacc + (warp * QC + qi) * H;
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) {
      const int d = 2 * lane + 64 * pi;
      if (d < H) dst[d] = acc[qi][pi][0];
      if (d + 1 < H) dst[d + 1] = acc[qi][pi][1];
    }
  }
}

// the warps' stashed (m, l, acc) merged in warp order into the partition's
// partial, for the block's chunk of queries
template <int QC>
__device__ __forceinline__ void merge_warps(const SplitArgs& a) {
  const BlockIds id = fresh_ids();
  const int H = a.H, G = (a.N / a.n_kv) * a.S, chunks = (G + QC - 1) / QC;
  const int p = id.x / chunks, c0 = (id.x % chunks) * QC, nq = min(QC, G - c0);
  const SplitSmem sm = split_smem<QC>(H);
  const size_t slot0 = (((size_t)id.r * a.n_kv + id.j) * a.n_part + p) * G + c0;
  float* part_acc = a.part + (size_t)a.B * a.n_kv * a.n_part * G * 2;
  for (int idx = id.tid; idx < nq * H; idx += kSplitThreads) {
    const int qi = idx / H, d = idx % H;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, sm.wm[w * QC + qi]);
    float sum = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float e = expf(sm.wm[w * QC + qi] - mx);
      sum += sm.wl[w * QC + qi] * e;
      num += sm.wacc[(w * QC + qi) * H + d] * e;
    }
    const size_t slot = slot0 + qi;
    part_acc[slot * H + d] = num;
    if (d == 0) {
      a.part[2 * slot] = mx;
      a.part[2 * slot + 1] = sum;
    }
  }
}

// launch 1: the partial (m, l, acc) of one partition of row blockIdx.z, kv
// head blockIdx.y, for one chunk of QC queries of its group (blockIdx.x =
// partition * chunks + chunk); a lane accumulates NP head-dim pairs (H <= 64 NP)
// (The minimum of one block an SM and the p V loop kept rolled are what keep
// ptxas from parking values in local memory in every instantiation.)
template <typename TQ, typename TKV, int QC, int NP>
__global__ void __launch_bounds__(kSplitThreads, 1) paged_decode_kernel(SplitArgs a) {
  // the combine may launch now: it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // packed, after the tile kernel (a programmatic dependent of it, with
  // disjoint outputs): one block waits for it, so this grid, and with it the
  // combine, ends after the tile kernel
  if (a.row_map && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int H = a.H, S = a.S, ps = a.ps, g = a.N / a.n_kv, G = g * S;
  const int chunks = (G + QC - 1) / QC;
  const int p = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * QC, j = blockIdx.y, r = blockIdx.z;
  const int nq = min(QC, G - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (a.row_map && in_multi_tile(a.row_map, a.pos, a.B, r, a.qt)) return;  // a tile's token
  const int t_begin = p * a.pp * ps;
  const int t_end = min(t_begin + a.pp * ps, row_walk(a.pos + r * S, S, a.W * ps, lane));
  if (t_begin >= t_end) return;  // past the row's last visible key: the combine skips it
  const SplitSmem sm = split_smem<QC>(H);
  const int kpr = a.kpr;
  unsigned char* ktile = sm.tiles + (size_t)warp * 2 * kpr * a.stride;
  unsigned char* vtile = ktile + (size_t)kpr * a.stride;
  float* pt = sm.pt + warp * 32 * QC;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* pk = static_cast<const TKV*>(a.pool_k);
  const TKV* pv = static_cast<const TKV*>(a.pool_v);
  const int32_t* bt_row = a.bt + (size_t)(a.row_map ? a.row_map[r] : r) * a.W;

  // rounds of kpr keys, one a lane, dealt to the warps in turn; the first
  // round's page is read before the queries are staged, to overlap the two
  int t0 = t_begin + kpr * warp;
  int page = lane < kpr && t0 + lane < t_end ? bt_row[(t0 + lane) / ps] : 0;
  for (int idx = tid; idx < QC * H; idx += kSplitThreads) {
    const int qi = idx / H, d = idx % H, gq = c0 + qi;
    sm.qs[idx] = qi < nq ? to_f32(q[((size_t)(r * S + gq % S) * a.N + j * g + gq / S) * H + d]) : 0.f;
  }
  int qpos[QC];
  float m[QC], l[QC], acc[QC][NP][2];
#pragma unroll
  for (int qi = 0; qi < QC; ++qi) {
    qpos[qi] = qi < nq ? a.pos[r * S + (c0 + qi) % S] : -1;
    m[qi] = kMasked;
    l[qi] = 0.f;
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) acc[qi][pi][0] = acc[qi][pi][1] = 0.f;
  }
  __syncthreads();

  for (; t0 < t_end; t0 += kpr * kSplitWarps) {
    const int t = t0 + lane;
    const bool valid = lane < kpr && t < t_end;
    // the key's K and V rows staged in the warp's tiles, both copies in
    // flight at once; its row of the pools counts rows of H elements (the
    // wrapper checks that there are fewer than 2^32)
    const unsigned row = valid ? ((unsigned)page * ps + t % ps) * a.n_kv + j : 0u;
    if (valid) {
      stage_row(ktile + lane * a.stride, pk + (size_t)row * H, H, a.vec);
      stage_row(vtile + lane * a.stride, pv + (size_t)row * H, H, a.vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float ksc = a.k_scale && valid ? a.k_scale[(size_t)page * a.n_kv + j] : 1.f;
    const float vsc = a.v_scale && valid ? a.v_scale[(size_t)page * a.n_kv + j] : 1.f;
    const int tn = t + kpr * kSplitWarps;  // the next round's page
    page = lane < kpr && tn < t_end ? bt_row[tn / ps] : 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    float sc[QC];
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) sc[qi] = 0.f;
    if (valid) dot_row<TKV, QC>(ktile + lane * a.stride, sm.qs, H, a.vec, sc);
    // the round's online-softmax update, f32 per warp; each key's
    // probabilities (times its V scale) go to the warp's table in shared memory
#pragma unroll
    for (int qi = 0; qi < QC; ++qi) {
      float pw = 0.f;
      if (qi < nq) {
        const bool vis = valid && t <= qpos[qi];
        const float x = vis ? sc[qi] * ksc * a.sm_scale : kMasked;
        const float m_new = fmaxf(m[qi], warp_max(x));
        const float e = vis ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[qi] - m_new);
        l[qi] = l[qi] * alpha + warp_sum(e);
        m[qi] = m_new;
#pragma unroll
        for (int pi = 0; pi < NP; ++pi) {
          acc[qi][pi][0] *= alpha;
          acc[qi][pi][1] *= alpha;
        }
        pw = e * vsc;
      }
      pt[lane * QC + qi] = pw;
    }
    __syncwarp();
    // p V: the lanes turn to head dims 2 lane + 64 pi and walk the staged V
    // rows key by key
    const int nk = min(kpr, t_end - t0);
#pragma unroll 1
    for (int kk = 0; kk < nk; ++kk) {
      const TKV* vr = reinterpret_cast<const TKV*>(vtile + kk * a.stride);
      float pw[QC];
      if constexpr (QC % 4 == 0) {
#pragma unroll
        for (int qi = 0; qi < QC; qi += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * QC + qi);
          pw[qi] = p4.x;
          pw[qi + 1] = p4.y;
          pw[qi + 2] = p4.z;
          pw[qi + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int qi = 0; qi < QC; ++qi) pw[qi] = pt[kk * QC + qi];
      }
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        const int d = 2 * lane + 64 * pi;
        if (d < H) {
          const float2 v = row_pair(vr, d);
#pragma unroll
          for (int qi = 0; qi < QC; ++qi) {
            acc[qi][pi][0] = fmaf(pw[qi], v.x, acc[qi][pi][0]);
            acc[qi][pi][1] = fmaf(pw[qi], v.y, acc[qi][pi][1]);
          }
        }
      }
    }
    __syncwarp();  // the tiles and the table are free for the next round
  }

  // the warps' states merged once, in warp order, into the partition's partial
  stash_warp<QC, NP>(a, m, l, acc);
  __syncthreads();
  merge_warps<QC>(a);
}

// launch 2: out for row blockIdx.y, kv head blockIdx.x, the row's walked
// partitions merged in partition order
template <typename TQ>
__global__ void __launch_bounds__(kSplitThreads) paged_combine_kernel(SplitArgs a) {
  const int j = blockIdx.x, r = blockIdx.y;
  const int H = a.H, S = a.S, g = a.N / a.n_kv, G = g * S;
  const int tpp = a.pp * a.ps;
  if (a.row_map && in_multi_tile(a.row_map, a.pos, a.B, r, a.qt)) return;
  // positions are an input: read before the wait
  const int used = (row_walk(a.pos + r * S, S, a.W * a.ps, threadIdx.x % 32) + tpp - 1) / tpp;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials are complete
  const size_t slot0 = ((size_t)r * a.n_kv + j) * a.n_part * G;
  const float* part_acc = a.part + (size_t)a.B * a.n_kv * a.n_part * G * 2;
  TQ* out = static_cast<TQ*>(a.out);
  for (int idx = threadIdx.x; idx < G * H; idx += kSplitThreads) {
    const int qi = idx / H, d = idx % H;
    float mx = kMasked;
#pragma unroll 4
    for (int p = 0; p < used; ++p) mx = fmaxf(mx, a.part[2 * (slot0 + (size_t)p * G + qi)]);
    float sum = 0.f, num = 0.f;
#pragma unroll 4
    for (int p = 0; p < used; ++p) {
      const size_t slot = slot0 + (size_t)p * G + qi;
      const float e = expf(a.part[2 * slot] - mx);
      sum += a.part[2 * slot + 1] * e;
      num += part_acc[slot * H + d] * e;
    }
    store_f32(num / fmaxf(sum, 1e-30f),
              &out[((size_t)(r * S + qi % S) * a.N + j * g + qi / S) * H + d]);
  }
}

// the first launch's instantiation: QC queries a chunk (1 for one query a
// group, 4 up to four, else 8; 4 where a lane holds four pairs, H > 128) and
// NP = ceil(H / 64) pairs a lane
template <typename TQ, typename TKV, int NP>
void (*first_kernel(int G))(SplitArgs) {
  if (G <= 1) return paged_decode_kernel<TQ, TKV, 1, NP>;
  if constexpr (NP == kMaxPairs) return paged_decode_kernel<TQ, TKV, 4, NP>;
  else return G <= 4 ? paged_decode_kernel<TQ, TKV, 4, NP> : paged_decode_kernel<TQ, TKV, 8, NP>;
}

// staged rows: 16-byte multiples, an odd number of them apart, so that the
// lanes' 16-byte reads of their own rows fall in distinct banks; kpr keys a
// warp a round, halved until the block's tiles fit kTileBudget
void split_layout(int row_bytes, int& stride, int& kpr) {
  stride = (row_bytes + 15) / 16 * 16;
  if (stride / 16 % 2 == 0) stride += 16;
  kpr = 32;
  while (kpr > 1 && kSplitWarps * 2 * kpr * stride > kTileBudget) kpr /= 2;
}

// pdl: the first launch as a programmatic dependent of the kernel before it
// (kernel 2's tile kernel)
template <typename TQ, typename TKV>
int launch_decode(SplitArgs a, cudaStream_t stream, bool pdl = false) {
  const int G = (a.N / a.n_kv) * a.S;
  const int np = (a.H + 63) / 64;
  void (*first)(SplitArgs) = np == 1   ? first_kernel<TQ, TKV, 1>(G)
                             : np == 2 ? first_kernel<TQ, TKV, 2>(G)
                                       : first_kernel<TQ, TKV, kMaxPairs>(G);
  const int qc = G <= 1 ? 1 : G <= 4 || np > 2 ? 4 : 8;
  split_layout(a.H * (int)sizeof(TKV), a.stride, a.kpr);
  const size_t smem = split_smem_bytes(qc, a.H, a.kpr, a.stride);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(first, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int chunks = (G + qc - 1) / qc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_part * chunks, a.n_kv, a.B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, first, a);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(a.n_kv, a.B);
  cfg.dynamicSmemBytes = 0;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_combine_kernel<TQ>, a);
}

// ---------------------------------------------------------------------------
// Kernel 2: tiles of two tokens or more on the tensor cores (design in the
// header note)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 64;     // query rows (token x head of the group) of a tile
constexpr int kTcThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// HPM: the head dim padded to a multiple of 16 is at most HPM (64, 128 or
// 256); KT keys a key tile (32 at HPM = 256, where the warp's 16 x 256 f32
// accumulator takes 128 registers a thread); LD the bf16 row stride of the
// tiles, an odd multiple of 16 bytes (conflict-free ldmatrix); RLD the byte
// stride of the int8 code rows
template <int HPM>
struct TileShape {
  static constexpr int KT = HPM > 128 ? 32 : 64;
  static constexpr int LD = HPM + 8;
  static constexpr int RLD = HPM + 16;
};

template <int HPM, bool kInt8>
__host__ __device__ constexpr size_t tile_smem_bytes() {
  using Sh = TileShape<HPM>;
  return sizeof(bf16) * Sh::LD * (kTcRows + 4 * Sh::KT) + sizeof(float) * 4 * Sh::KT +
         (kInt8 ? 4 * (size_t)Sh::KT * Sh::RLD : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// n bytes (16 or 8) from src to smem dst by cp.async, or zeros when !ok
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool ok, int n) {
  if (n == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(ok ? 8 : 0));
}

// one block per (first token of a tile of two tokens or more, kv head); any
// other token's block returns at once.  The tile's c tokens x g heads are
// the rows of a 64-row query tile (row = token * g + head), warp w rows
// 16w..16w+15.  The row's keys up to the tile's last position are walked in
// tiles of KT through two buffers; K and V rows are gathered from their pages
// by cp.async (16 bytes of bf16, 8 of int8 codes: H % 8 == 0), int8 codes then
// widened to bf16 in shared memory (exact).  S = Q K^T on the tensor cores;
// an int8 page's K scale multiplies the f32 scores and its V scale the
// probabilities, before they round to bf16 as the A operand of P V; the
// online softmax is flash attention's (exp2, row max and sum over the quad).
// A key past a row's position is masked: a key tile that a row cannot see
// leaves its (m, l, O) exactly as they were
template <typename TKV, int HPM>
__global__ void __launch_bounds__(kTcThreads) packed_tile_kernel(SplitArgs a) {
  using Sh = TileShape<HPM>;
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int KT = Sh::KT, LD = Sh::LD, RLD = Sh::RLD;
  extern __shared__ __align__(16) unsigned char smem_tile[];
  __shared__ int tile_len;
  // kernel 1's pair may start now: its walk reads only inputs, and its
  // outputs are the other tokens'
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t = blockIdx.x, j = blockIdx.y, T = a.B;
  const int32_t* rm = a.row_map;
  const int32_t* pos = a.pos;
  if (!tile_start(rm, pos, t, a.qt)) return;
  // the tile's length: the distance to the next tile start (or to T), found
  // by the threads together (a tile spans at most qt <= 64 tokens)
  if (threadIdx.x == 0) tile_len = kTcRows;
  __syncthreads();
  if (threadIdx.x < kTcRows - 1) {
    const int u = t + 1 + threadIdx.x;
    if (u >= T || tile_start(rm, pos, u, a.qt)) atomicMin(&tile_len, 1 + threadIdx.x);
  }
  __syncthreads();
  const int c = tile_len;
  if (c < 2) return;  // a tile of one token: kernel 1's pair takes it

  bf16* qs = reinterpret_cast<bf16*>(smem_tile);
  bf16* ks = qs + kTcRows * LD;   // two buffers
  bf16* vs = ks + 2 * KT * LD;    // two buffers
  float* ksc = reinterpret_cast<float*>(vs + 2 * KT * LD);  // two buffers of KT
  float* vsc = ksc + 2 * KT;
  unsigned char* kraw = reinterpret_cast<unsigned char*>(vsc + 2 * KT);  // int8: two buffers
  unsigned char* vraw = kraw + 2 * KT * RLD;

  const int H = a.H, HP = (H + 15) / 16 * 16, ksteps = HP / 16, ps = a.ps;
  const int g = a.N / a.n_kv, R = c * g;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, gr = lane / 4, tq = lane % 4;
  const int walk = min(a.W * ps, pos[t + c - 1] + 1);  // keys the tile's last token sees
  const int n_kt = (walk + KT - 1) / KT;
  const int32_t* bt_row = a.bt + (size_t)rm[t] * a.W;
  const bf16* q = static_cast<const bf16*>(a.q);
  const TKV* pk = static_cast<const TKV*>(a.pool_k);
  const TKV* pv = static_cast<const TKV*>(a.pool_v);
  const int chunks = H / 8;  // 8 elements a copy

  // the head's padding columns [H, HP) of every tile: zero once (no copy writes them)
  if (HP > H)
    for (int i = tid; i < (kTcRows + 4 * KT) * (HP - H); i += kTcThreads) {
      const int r = i / (HP - H);
      qs[r * LD + H + i % (HP - H)] = __float2bfloat16_rn(0.f);
    }
  // Q: row rho is token t + rho / g, head j g + rho % g; rows past R are zero
  for (int e = tid; e < kTcRows * chunks; e += kTcThreads) {
    const int rho = e / chunks, cc = (e % chunks) * 8;
    const bool ok = rho < R;
    const bf16* src = ok ? q + ((size_t)(t + rho / g) * a.N + j * g + rho % g) * H + cc : q;
    cp_async_n(qs + rho * LD + cc, src, ok, 16);
  }
  // key tile kt's K and V rows (zero past the walk) and page scales into buf
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * KT;
    for (int e = tid; e < KT * chunks; e += kTcThreads) {
      const int row = e / chunks, cc = (e % chunks) * 8, key = k0 + row;
      const bool ok = key < walk;
      const size_t off =
          ok ? (((size_t)bt_row[key / ps] * ps + key % ps) * a.n_kv + j) * H + cc : 0;
      if constexpr (kInt8) {
        cp_async_n(kraw + (buf * KT + row) * RLD + cc, pk + off, ok, 8);
        cp_async_n(vraw + (buf * KT + row) * RLD + cc, pv + off, ok, 8);
      } else {
        cp_async_n(ks + (buf * KT + row) * LD + cc, pk + off, ok, 16);
        cp_async_n(vs + (buf * KT + row) * LD + cc, pv + off, ok, 16);
      }
    }
    if (tid < KT) {
      const int key = k0 + tid;
      const size_t page = key < walk ? (size_t)bt_row[key / ps] : 0;
      ksc[buf * KT + tid] = a.k_scale ? a.k_scale[page * a.n_kv + j] : 1.f;
      vsc[buf * KT + tid] = a.v_scale ? a.v_scale[page * a.n_kv + j] : 1.f;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // int8: buf's codes widened into its bf16 tiles
  auto widen = [&](int buf) {
    for (int e = tid; e < 2 * KT * chunks; e += kTcThreads) {
      const bool is_v = e >= KT * chunks;
      const int i = is_v ? e - KT * chunks : e, row = i / chunks, cc = (i % chunks) * 8;
      const uint2 v = *reinterpret_cast<const uint2*>((is_v ? vraw : kraw) + (buf * KT + row) * RLD + cc);
      const uint32_t w2[2] = {v.x, v.y};
      uint32_t o[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint32_t word = w2[h / 2] >> (16 * (h % 2));
        o[h] = pack_bf16(static_cast<float>(static_cast<int8_t>(word & 0xff)),
                         static_cast<float>(static_cast<int8_t>(word >> 8)));
      }
      *reinterpret_cast<uint4*>((is_v ? vs : ks) + (buf * KT + row) * LD + cc) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  };

  stage(0, 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if constexpr (kInt8) {
    widen(0);
    __syncthreads();
  }

  float o[HPM / 8][4];
#pragma unroll
  for (int dt = 0; dt < HPM / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int rpos[2];  // the lane's rows' positions; -1 (nothing visible) past R
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rho = w * 16 + gr + 8 * i;
    rpos[i] = rho < R ? pos[t] + rho / g : -1;
  }
  const float sl2 = a.sm_scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) stage(kt + 1, buf ^ 1);
    const bf16* kb = ks + buf * KT * LD;
    const bf16* vb = vs + buf * KT * LD;
    const float* kscb = ksc + buf * KT;
    const float* vscb = vsc + buf * KT;
    const int k0 = kt * KT;

    // S = Q K^T, 16 x KT per warp
    float sc[KT / 8][4];
#pragma unroll
    for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HPM / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t qa[4];
      ldsm_x4(qa, qs + (w * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < KT / 16; ++p) {
        uint32_t bk[4];
        ldsm_x4(bk, kb + (p * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma(sc[2 * p], qa, bk[0], bk[1]);
        mma(sc[2 * p + 1], qa, bk[2], bk[3]);
      }
    }

    // online softmax over the lane's rows gr (i = 0) and gr + 8 (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = jj * 8 + 2 * tq + e, key = k0 + kl;
          float x = sc[jj][2 * i + e] * kscb[kl] * sl2;
          if (key > rpos[i] || key >= walk) x = -INFINITY;
          sc[jj][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - base);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[jj][2 * i + e] - base);
          sum += p;
          sc[jj][2 * i + e] = kInt8 ? p * vscb[jj * 8 + 2 * tq + e] : p;
        }
      l[i] = l[i] * alpha + sum;  // this lane's columns; summed over the quad at the end
#pragma unroll
      for (int dt = 0; dt < HPM / 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P as bf16 A fragments straight from the score accumulators
#pragma unroll
    for (int cc = 0; cc < KT / 16; ++cc) {
      uint32_t pa[4] = {pack_bf16(sc[2 * cc][0], sc[2 * cc][1]), pack_bf16(sc[2 * cc][2], sc[2 * cc][3]),
                        pack_bf16(sc[2 * cc + 1][0], sc[2 * cc + 1][1]),
                        pack_bf16(sc[2 * cc + 1][2], sc[2 * cc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HPM / 16; ++dp) {
        if (dp >= ksteps) break;
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + (cc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 + (lane / 16) * 8);
        mma(o[2 * dp], pa, bv[0], bv[1]);
        mma(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the next tile has landed; this one is no longer read
    if constexpr (kInt8) {
      if (kt + 1 < n_kt) {
        widen(buf ^ 1);
        __syncthreads();
      }
    }
  }

  // out = O / l for the tile's rows, straight from registers, two columns a store
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int rho = w * 16 + gr + 8 * i;
    if (rho >= R) continue;
    bf16* dst = out + ((size_t)(t + rho / g) * a.N + j * g + rho % g) * H;
#pragma unroll
    for (int dt = 0; dt < HPM / 8; ++dt) {
      const int col = dt * 8 + 2 * tq;
      if (col < H)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    }
  }
}

// the tile kernel for the head dim's HPM, launched over every (token, kv head)
template <typename TKV, int HPM>
int launch_tiles_hpm(const SplitArgs& a, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<HPM, sizeof(TKV) == 1>();
  static const cudaError_t sized = cudaFuncSetAttribute(
      packed_tile_kernel<TKV, HPM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (sized != cudaSuccess) return (int)sized;
  packed_tile_kernel<TKV, HPM><<<dim3(a.B, a.n_kv), kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_tiles(const SplitArgs& a, cudaStream_t stream) {
  const int hp = (a.H + 15) / 16 * 16;
  if (hp <= 64) return launch_tiles_hpm<TKV, 64>(a, stream);
  if (hp <= 128) return launch_tiles_hpm<TKV, 128>(a, stream);
  return launch_tiles_hpm<TKV, 256>(a, stream);
}

// kernel 2: the tiles of two tokens or more on the tensor cores (bf16 q over
// a bf16 or int8 pool, when the wrapper gives qt >= 2), then kernel 1's pair
// over the window's other tokens, each a row of one query with its own table
// row (row_map) and position; the pair's walk as a programmatic dependent of
// the tiles, so the two run side by side
template <typename TQ, typename TKV>
int launch_packed(SplitArgs a, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, bf16>::value && !std::is_same<TKV, float>::value) {
    if (a.qt >= 2) {
      const int err = launch_tiles<TKV>(a, stream);
      if (err) return err;
      return launch_decode<TQ, TKV>(a, stream, true);  // overlaps the tiles
    }
  } else if (a.qt >= 2) {
    return (int)cudaErrorInvalidValue;  // the tensor-core tiles take bf16 q and a bf16 or int8 pool
  }
  return launch_decode<TQ, TKV>(a, stream);
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only).  Calls
// launch_packed<TQ, TKV> or launch_decode<TQ, TKV>
template <bool kPacked, typename TQ>
int launch_kv(int kv_dtype, const SplitArgs& a, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return kPacked ? launch_packed<TQ, float>(a, stream) : launch_decode<TQ, float>(a, stream);
    case 1:
      return kPacked ? launch_packed<TQ, bf16>(a, stream) : launch_decode<TQ, bf16>(a, stream);
    case 2:
      return kPacked ? launch_packed<TQ, int8_t>(a, stream) : launch_decode<TQ, int8_t>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kPacked>
int launch_any(int q_dtype, int kv_dtype, const SplitArgs& a, cudaStream_t stream) {
  if (a.B == 0) return (int)cudaSuccess;
  switch (q_dtype) {
    case 0: return launch_kv<kPacked, float>(kv_dtype, a, stream);
    case 1: return launch_kv<kPacked, bf16>(kv_dtype, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the arguments both C entries check; vec as SplitArgs::vec
bool bad_split(int B, int S, int N, int n_kv, int H, int W, int ps, int pp, int n_part) {
  return B < 0 || S < 1 || n_kv < 1 || N % n_kv || H < 1 || H > 64 * kMaxPairs || W < 1 ||
         ps < 1 || pp < 1 || n_part != (W + pp - 1) / pp || n_kv > 65535 || B > 65535;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// the most dynamic shared memory a block of a paged call takes at G queries
// per kv head and head dim H: kernel 1's first launch (its rows staged at
// the widest, f32) or kernel 2's tile kernel (the int8 layout, the larger)
size_t paged_attention_smem_bytes(int G, int H) {
  const int np = (H + 63) / 64;
  const int qc = G <= 1 ? 1 : G <= 4 || np > 2 ? 4 : 8;
  int stride, kpr;
  split_layout(H * 4, stride, kpr);
  const size_t split = split_smem_bytes(qc, H, kpr, stride);
  const int hp = (H + 15) / 16 * 16;
  const size_t tile = hp <= 64    ? tile_smem_bytes<64, true>()
                      : hp <= 128 ? tile_smem_bytes<128, true>()
                                  : tile_smem_bytes<256, true>();
  return split > tile ? split : tile;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, S, N, H); bt (B, W); pos (B, S); out (B, S, N, H).  The split schedule
// (pp pages a partition, n_part = ceil(W / pp) partitions a row) comes from
// the wrapper, which chooses it from W and ps alone; part holds
// B * n_kv * n_part * G * (H + 2) f32, G = (N / n_kv) * S.
int paged_decode_attention_launch(const void* q, const void* pool_k, const void* pool_v,
                                  const int32_t* bt, const int32_t* pos,
                                  const float* k_scale, const float* v_scale, float* part,
                                  void* out, int B, int S, int N, int n_kv, int H, int W, int ps,
                                  int pp, int n_part, float sm_scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  const size_t kv_bytes = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  if (bad_split(B, S, N, n_kv, H, W, ps, pp, n_part)) return (int)cudaErrorInvalidValue;
  const int vec = (H * kv_bytes) % 16 == 0 && aligned16(pool_k) && aligned16(pool_v);
  SplitArgs a{q, pool_k, pool_v, bt, pos, nullptr, k_scale, v_scale, part, out,
              B, S, N, n_kv, H, W, ps, pp, n_part, sm_scale, vec, 0, 0, 0};
  return launch_any<false>(q_dtype, kv_dtype, a, static_cast<cudaStream_t>(stream));
}

// q (T, N, H); bt (rows, W); row_map (T,); pos (T,); out (T, N, H).  qt:
// the tokens a tensor-core tile spans at most (the wrapper's
// packed_tokens_per_tile), 0 when no tile runs there; it needs bf16 q over a
// bf16 or int8 pool, qt (N / n_kv) <= 64, H a multiple of 8 and aligned
// pointers.  The other tokens go through kernel 1's pair, each a row of S = 1
// with its own table row: (pp, n_part) and part as there, B = T.
int packed_paged_attention_launch(const void* q, const void* pool_k, const void* pool_v,
                                  const int32_t* bt, const int32_t* row_map,
                                  const int32_t* pos, const float* k_scale,
                                  const float* v_scale, float* part, void* out, int T, int N,
                                  int n_kv, int H, int W, int ps, int pp, int n_part, int qt,
                                  float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  const size_t kv_bytes = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  if (bad_split(T, 1, N, n_kv, H, W, ps, pp, n_part) || qt < 0 || qt == 1 ||
      (qt > 1 && (q_dtype != 1 || kv_dtype == 0 || qt * (N / n_kv) > kTcRows || H % 8 ||
                  !aligned16(q) || !aligned16(pool_k) || !aligned16(pool_v))))
    return (int)cudaErrorInvalidValue;
  const int vec = (H * kv_bytes) % 16 == 0 && aligned16(pool_k) && aligned16(pool_v);
  SplitArgs a{q, pool_k, pool_v, bt, pos, row_map, k_scale, v_scale, part, out,
              T, 1, N, n_kv, H, W, ps, pp, n_part, sm_scale, vec, 0, 0, qt};
  return launch_any<true>(q_dtype, kv_dtype, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
