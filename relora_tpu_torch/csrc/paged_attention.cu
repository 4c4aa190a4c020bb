// Paged attention straight out of the KV page pool, for sm_90a.
//
//   paged_decode_kernel +  replace relora_tpu/ops/attention.py:244
//   paged_combine_kernel   _paged_decode_kernel (paged_decode_attention, :331):
//                          small-S decode/verify attention, q (B, S, N, H),
//                          S <= 16 in the serving path.
//   packed_paged_kernel    replaces relora_tpu/ops/attention.py:447
//                          _packed_paged_kernel (packed_paged_attention, :532):
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
// group, far below the H100's ~295 flops/byte balance point, so the tensor
// cores are no lever.  The least time is the bytes of the visible K/V rows
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
// Kernel 2 keeps the first design (attend_pages): one block per (packed
// token, kv head) walks the token's pages one at a time, each staged in
// shared memory as f32, with scalar FMAs.  Its work differs (many prefill
// tokens of one row share pages, which calls for tiled tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

struct Args {
  const void* q;          // (R, S, N, H) in TQ
  const void* pool_k;     // (P, ps, n_kv, H) in TKV
  const void* pool_v;
  const int32_t* bt;      // (rows, W) block tables
  const int32_t* row_map; // (R,) table row per query row, or null (row = r)
  const int32_t* pos;     // (R, S) absolute positions
  const float* k_scale;   // (P, n_kv) or null (unquantised)
  const float* v_scale;
  void* out;              // (R, S, N, H) in TQ
  int S, N, n_kv, H, W, ps;
  float sm_scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats: q (G*H), K page (ps*H), V page (ps*H),
// scores/probabilities (G*ps), acc (G*H), m, l, alpha (G each), then G ints
// of query positions.
__host__ __device__ inline size_t smem_bytes(int G, int H, int ps) {
  return sizeof(float) * (2 * (size_t)G * H + 2 * (size_t)ps * H + (size_t)G * ps + 3 * (size_t)G) +
         sizeof(int) * (size_t)G;
}

template <typename TQ, typename TKV>
__device__ void attend_pages(const Args& a) {
  extern __shared__ float smem[];
  __shared__ int n_walk;
  const int r = blockIdx.x;
  const int j = blockIdx.y;
  const int H = a.H, ps = a.ps, S = a.S;
  const int g = a.N / a.n_kv;
  const int G = g * S;
  const int tid = threadIdx.x;

  float* qs = smem;
  float* ks = qs + G * H;
  float* vs = ks + ps * H;
  float* sc = vs + ps * H;
  float* acc = sc + G * ps;
  float* m = acc + G * H;
  float* l = m + G;
  float* alpha = l + G;
  int* qpos = reinterpret_cast<int*>(alpha + G);

  const TQ* q = static_cast<const TQ*>(a.q);
  // query qi = h*S + s holds token s of head j*g + h (head-major group block)
  for (int idx = tid; idx < G * H; idx += blockDim.x) {
    const int qi = idx / H, d = idx % H;
    const int h = qi / S, s = qi % S;
    qs[idx] = to_f32(q[((size_t)(r * S + s) * a.N + j * g + h) * H + d]);
    acc[idx] = 0.f;
  }
  for (int qi = tid; qi < G; qi += blockDim.x) {
    qpos[qi] = a.pos[r * S + qi % S];
    m[qi] = kMasked;
    l[qi] = 0.f;
  }
  if (tid == 0) {
    int mx = -1;
    for (int s = 0; s < S; ++s) mx = max(mx, a.pos[r * S + s]);
    n_walk = mx < 0 ? 0 : min(a.W, mx / ps + 1);
  }
  __syncthreads();

  const int row = a.row_map ? a.row_map[r] : r;
  const int32_t* bt_row = a.bt + (size_t)row * a.W;
  const TKV* pk = static_cast<const TKV*>(a.pool_k);
  const TKV* pv = static_cast<const TKV*>(a.pool_v);
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  for (int w = 0; w < n_walk; ++w) {
    const int page = bt_row[w];
    const float kscale = a.k_scale ? a.k_scale[(size_t)page * a.n_kv + j] : 1.f;
    const float vscale = a.v_scale ? a.v_scale[(size_t)page * a.n_kv + j] : 1.f;
    for (int idx = tid; idx < ps * H; idx += blockDim.x) {
      const int i = idx / H, d = idx % H;
      const size_t off = (((size_t)page * ps + i) * a.n_kv + j) * H + d;
      ks[idx] = to_f32(pk[off]) * kscale;
      vs[idx] = to_f32(pv[off]) * vscale;
    }
    __syncthreads();

    for (int idx = tid; idx < G * ps; idx += blockDim.x) {
      const int qi = idx / ps, i = idx % ps;
      float dot = 0.f;
      for (int d = 0; d < H; ++d) dot = fmaf(qs[qi * H + d], ks[i * H + d], dot);
      sc[idx] = (w * ps + i <= qpos[qi]) ? dot * a.sm_scale : kMasked;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int qi = warp; qi < G; qi += n_warps) {
      float mx = kMasked;
      for (int i = lane; i < ps; i += 32) mx = fmaxf(mx, sc[qi * ps + i]);
      mx = warp_max(mx);
      const float m_prev = m[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < ps; i += 32) {
        const float p = (w * ps + i <= qpos[qi]) ? expf(sc[qi * ps + i] - m_new) : 0.f;
        sc[qi * ps + i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_new);
        alpha[qi] = al;
        l[qi] = l[qi] * al + sum;
        m[qi] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * H; idx += blockDim.x) {
      const int qi = idx / H, d = idx % H;
      float pvsum = 0.f;
      for (int i = 0; i < ps; ++i) pvsum = fmaf(sc[qi * ps + i], vs[i * H + d], pvsum);
      acc[idx] = acc[idx] * alpha[qi] + pvsum;
    }
    __syncthreads();
  }

  TQ* out = static_cast<TQ*>(a.out);
  for (int idx = tid; idx < G * H; idx += blockDim.x) {
    const int qi = idx / H, d = idx % H;
    const int h = qi / S, s = qi % S;
    store_f32(acc[idx] / fmaxf(l[qi], 1e-30f),
              &out[((size_t)(r * S + s) * a.N + j * g + h) * H + d]);
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) packed_paged_kernel(Args a) {
  attend_pages<TQ, TKV>(a);
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
  const int32_t* bt;     // (B, W) block tables
  const int32_t* pos;    // (B, S) absolute positions
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
};

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
  const int H = a.H, S = a.S, ps = a.ps, g = a.N / a.n_kv, G = g * S;
  const int chunks = (G + QC - 1) / QC;
  const int p = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * QC, j = blockIdx.y, r = blockIdx.z;
  const int nq = min(QC, G - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
  const int32_t* bt_row = a.bt + (size_t)r * a.W;

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

template <typename TQ, typename TKV>
int launch_decode(SplitArgs a, cudaStream_t stream) {
  const int G = (a.N / a.n_kv) * a.S;
  const int np = (a.H + 63) / 64;
  void (*first)(SplitArgs) = np == 1   ? first_kernel<TQ, TKV, 1>(G)
                             : np == 2 ? first_kernel<TQ, TKV, 2>(G)
                                       : first_kernel<TQ, TKV, kMaxPairs>(G);
  const int qc = G <= 1 ? 1 : G <= 4 || np > 2 ? 4 : 8;
  // staged rows: 16-byte multiples, an odd number of them apart, so that the
  // lanes' 16-byte reads of their own rows fall in distinct banks
  const int row_bytes = a.H * (int)sizeof(TKV);
  a.stride = (row_bytes + 15) / 16 * 16;
  if (a.stride / 16 % 2 == 0) a.stride += 16;
  a.kpr = 32;
  while (a.kpr > 1 && kSplitWarps * 2 * a.kpr * a.stride > kTileBudget) a.kpr /= 2;
  const size_t smem = split_smem_bytes(qc, a.H, a.kpr, a.stride);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(first, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int chunks = (G + qc - 1) / qc;
  first<<<dim3(a.n_part * chunks, a.n_kv, a.B), kSplitThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_kv, a.B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_combine_kernel<TQ>, a);
}

template <typename TQ, typename TKV>
int launch_packed(const Args& a, int R, cudaStream_t stream) {
  const int G = a.N / a.n_kv;
  const size_t smem = smem_bytes(G, a.H, a.ps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_paged_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  packed_paged_kernel<TQ, TKV><<<dim3(R, a.n_kv), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only).  Calls
// launch_decode<TQ, TKV> (args: SplitArgs) or launch_packed<TQ, TKV> (Args, R)
template <bool kPacked, typename TQ, typename A>
int launch_kv(int kv_dtype, const A& a, int R, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      if constexpr (kPacked) return launch_packed<TQ, float>(a, R, stream);
      else return launch_decode<TQ, float>(a, stream);
    case 1:
      if constexpr (kPacked) return launch_packed<TQ, __nv_bfloat16>(a, R, stream);
      else return launch_decode<TQ, __nv_bfloat16>(a, stream);
    case 2:
      if constexpr (kPacked) return launch_packed<TQ, int8_t>(a, R, stream);
      else return launch_decode<TQ, int8_t>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kPacked, typename A>
int launch_any(int q_dtype, int kv_dtype, const A& a, int R, cudaStream_t stream) {
  if (R == 0) return (int)cudaSuccess;
  switch (q_dtype) {
    case 0: return launch_kv<kPacked, float>(kv_dtype, a, R, stream);
    case 1: return launch_kv<kPacked, __nv_bfloat16>(kv_dtype, a, R, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t paged_attention_smem_bytes(int G, int H, int ps) { return smem_bytes(G, H, ps); }

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
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B < 0 || S < 1 || n_kv < 1 || N % n_kv || H < 1 || H > 64 * kMaxPairs || W < 1 || ps < 1 ||
      pp < 1 || n_part != (W + pp - 1) / pp || n_kv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = (H * kv_bytes) % 16 == 0 && aligned(pool_k) && aligned(pool_v);
  SplitArgs a{q, pool_k, pool_v, bt, pos, k_scale, v_scale, part, out,
              B, S, N, n_kv, H, W, ps, pp, n_part, sm_scale, vec, 0, 0};
  return launch_any<false>(q_dtype, kv_dtype, a, B, static_cast<cudaStream_t>(stream));
}

// q (T, N, H); bt (rows, W); row_map (T,); pos (T,); out (T, N, H)
int packed_paged_attention_launch(const void* q, const void* pool_k, const void* pool_v,
                                  const int32_t* bt, const int32_t* row_map,
                                  const int32_t* pos, const float* k_scale,
                                  const float* v_scale, void* out, int T, int N, int n_kv,
                                  int H, int W, int ps, float sm_scale, int q_dtype,
                                  int kv_dtype, void* stream) {
  Args a{q, pool_k, pool_v, bt, row_map, pos, k_scale, v_scale, out,
         1, N, n_kv, H, W, ps, sm_scale};
  return launch_any<true>(q_dtype, kv_dtype, a, T, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
