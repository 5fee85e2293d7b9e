// Beam search over inline neighbour rows, one warp per query.
//
// The GPU form of ops/search.py `_beam_search_packed` (dedup="beam",
// expand=1): same packed (distance << id_bits) | id keys, same expansion
// order, same termination rule, same visited and step counts. The beam and
// its expanded flags stay in shared memory for the whole search; each
// expansion reads the expanded node's adjacency row and its inline
// neighbour-sketch row (two contiguous rows) and XOR/popcounts them against
// the query.
//
// Per step, for one warp:
//   1. frontier: the smallest unexpanded key (warp min-reduction); stop when
//      none is left or max_steps is reached;
//   2. candidates: lane l scores neighbours l, l+32, ... of the expanded node;
//      a candidate whose key is already in the beam is dropped (binary search
//      in the sorted beam);
//   3. the candidates are sorted (bitonic network in shared memory) and
//      repeated ids within the row are dropped;
//   4. merge: every surviving key's rank in the union is its index plus the
//      number of smaller keys in the other sorted list; ranks < ef are
//      written to the next beam.
//
// Built by native/Makefile (`make cuda`) for sm_90a and called through
// jax.ffi (hnsw_itu/ops/beam_kernel.py).

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarps = 4;     // queries per block
constexpr int kSlots = 128;   // max beam width and max padded row width
constexpr unsigned kFull = 0xffffffffu;

// Number of entries of the ascending array a[0, n) that are < v.
__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Ascending bitonic sort of c[0, n), n a power of two, by one warp.
__device__ __forceinline__ void warp_sort(int32_t* c, int n, int lane) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < (n >> 1); p += 32) {
        int i = ((p / j) * 2 * j) + (p % j);
        int32_t a = c[i], b = c[i + j];
        bool asc = (i & k) == 0;
        if ((a > b) == asc) { c[i] = b; c[i + j] = a; }
      }
      __syncwarp();
    }
  }
}

template <int WORDS>
__global__ void __launch_bounds__(kWarps * 32)
beam_kernel(const uint32_t* __restrict__ queries,
            const int32_t* __restrict__ init,
            const int32_t* __restrict__ adj,
            const uint32_t* __restrict__ rows,
            int32_t* __restrict__ out_keys, int32_t* __restrict__ out_vis,
            int32_t* __restrict__ out_steps, int B, int cap, int W, int CP,
            int ef, int id_bits, int max_d, int max_steps) {
  __shared__ int32_t s_key[kWarps][2][kSlots];
  __shared__ uint8_t s_flag[kWarps][2][kSlots];
  __shared__ int32_t s_cand[kWarps][kSlots];
  __shared__ __align__(16) uint32_t s_q[kWarps][WORDS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps only: no block-wide barrier is used

  const int32_t kinf = (max_d + 1) << id_bits;
  const int32_t mask = (1 << id_bits) - 1;
  int32_t* key = s_key[warp][0];
  int32_t* nkey = s_key[warp][1];
  uint8_t* flag = s_flag[warp][0];
  uint8_t* nflag = s_flag[warp][1];
  int32_t* cand = s_cand[warp];
  uint32_t* q = s_q[warp];

  for (int w = lane; w < WORDS; w += 32) q[w] = queries[(size_t)b * WORDS + w];
  for (int i = lane; i < kSlots; i += 32) {
    key[i] = kinf;
    flag[i] = 0;
  }
  __syncwarp();
  if (lane == 0) key[0] = init[b];
  __syncwarp();

  int visited = 1, steps = 0;
  while (steps < max_steps) {
    // 1. frontier: the beam is sorted, so every entry is <= beam[ef-1] and
    //    the next expansion is the smallest unexpanded valid key
    int32_t m = kinf;
    for (int i = lane; i < ef; i += 32)
      if (!flag[i] && key[i] < m) m = key[i];
    m = __reduce_min_sync(kFull, m);
    if (m >= kinf) break;
    ++steps;
    for (int i = lane; i < ef; i += 32)
      if (key[i] == m) flag[i] = 1;
    const int e = min(m & mask, cap - 1);

    // 2. candidate keys of the expanded node's row
    const int32_t* arow = adj + (size_t)e * W;
    const uint4* prow = reinterpret_cast<const uint4*>(rows + (size_t)e * W * WORDS);
    const uint4* qv = reinterpret_cast<const uint4*>(q);
    for (int n = lane; n < CP; n += 32) {
      int32_t ck = kinf;
      if (n < W) {
        const int32_t id = __ldg(arow + n);
        if (id >= 0) {
          int d = 0;
#pragma unroll
          for (int t = 0; t < WORDS / 4; ++t) {
            const uint4 a = __ldg(prow + n * (WORDS / 4) + t);
            const uint4 c = qv[t];
            d += __popc(a.x ^ c.x) + __popc(a.y ^ c.y) + __popc(a.z ^ c.z) +
                 __popc(a.w ^ c.w);
          }
          ck = (min(d, max_d) << id_bits) | id;
          // equal id <=> equal key: already in the beam, drop it
          const int pos = lower_bound(key, ef, ck);
          if (pos < ef && key[pos] == ck) ck = kinf;
        }
      }
      cand[n] = ck;
    }
    __syncwarp();

    // 3. sort the row's candidates; drop ids repeated within the row
    warp_sort(cand, CP, lane);
    int fresh = 0;
    bool dup = false;
    for (int n = lane; n < CP; n += 32) {
      const int32_t v = cand[n];
      if (v < kinf) {
        if (n > 0 && cand[n - 1] == v) dup = true; else ++fresh;
      }
    }
    visited += __reduce_add_sync(kFull, fresh);
    if (__any_sync(kFull, dup)) {
      __syncwarp();
      bool kill[kSlots / 32];
      for (int n = lane, r = 0; n < CP; n += 32, ++r)
        kill[r] = n > 0 && cand[n] < kinf && cand[n - 1] == cand[n];
      __syncwarp();
      for (int n = lane, r = 0; n < CP; n += 32, ++r)
        if (kill[r]) cand[n] = kinf;
      __syncwarp();
      warp_sort(cand, CP, lane);
    }

    // 4. merge by rank into the next beam
    for (int i = lane; i < ef; i += 32) {
      nkey[i] = kinf;
      nflag[i] = 0;
    }
    __syncwarp();
    for (int i = lane; i < ef; i += 32) {
      const int32_t v = key[i];
      if (v < kinf) {
        const int r = i + lower_bound(cand, CP, v);
        if (r < ef) { nkey[r] = v; nflag[r] = flag[i]; }
      }
    }
    for (int j = lane; j < CP; j += 32) {
      const int32_t v = cand[j];
      if (v < kinf) {
        const int r = j + lower_bound(key, ef, v);
        if (r < ef) { nkey[r] = v; nflag[r] = 0; }
      }
    }
    __syncwarp();
    int32_t* tk = key; key = nkey; nkey = tk;
    uint8_t* tf = flag; flag = nflag; nflag = tf;
  }

  for (int i = lane; i < ef; i += 32) out_keys[(size_t)b * ef + i] = key[i];
  if (lane == 0) {
    out_vis[b] = visited;
    out_steps[b] = steps;
  }
}

template <int WORDS>
cudaError_t launch(cudaStream_t stream, const uint32_t* queries,
                   const int32_t* init, const int32_t* adj,
                   const uint32_t* rows, int32_t* keys, int32_t* vis,
                   int32_t* steps, int B, int cap, int W, int CP, int ef,
                   int id_bits, int max_d, int max_steps) {
  const int blocks = (B + kWarps - 1) / kWarps;
  beam_kernel<WORDS><<<blocks, kWarps * 32, 0, stream>>>(
      queries, init, adj, rows, keys, vis, steps, B, cap, W, CP, ef, id_bits,
      max_d, max_steps);
  return cudaGetLastError();
}

ffi::Error BeamSearchImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> queries,
                          ffi::Buffer<ffi::S32> init, ffi::Buffer<ffi::S32> adj,
                          ffi::Buffer<ffi::U32> rows,
                          ffi::ResultBuffer<ffi::S32> keys,
                          ffi::ResultBuffer<ffi::S32> vis,
                          ffi::ResultBuffer<ffi::S32> steps, int32_t ef,
                          int32_t id_bits, int32_t max_d, int32_t max_steps) {
  const auto qd = queries.dimensions();
  const auto ad = adj.dimensions();
  const auto rd = rows.dimensions();
  if (qd.size() != 2 || ad.size() != 2 || rd.size() != 2)
    return ffi::Error::InvalidArgument("beam_search: expected 2-D operands");
  const int B = static_cast<int>(qd[0]);
  const int words = static_cast<int>(qd[1]);
  const int cap = static_cast<int>(ad[0]);
  const int W = static_cast<int>(ad[1]);
  if (rd[0] != cap || rd[1] != static_cast<int64_t>(W) * words)
    return ffi::Error::InvalidArgument("beam_search: rows must be [cap, W*words]");
  if (words != 32)
    return ffi::Error::InvalidArgument("beam_search: sketches must be 32 words (1024 bits)");
  if (W < 1 || W > kSlots || ef < 1 || ef > kSlots)
    return ffi::Error::InvalidArgument("beam_search: W and ef must be in [1, 128]");
  if (id_bits < 1 || id_bits > 30 || ((int64_t)(max_d + 1) << id_bits) > INT32_MAX)
    return ffi::Error::InvalidArgument("beam_search: key does not fit int32");
  int CP = 32;
  while (CP < W) CP <<= 1;
  const uint32_t* q = queries.typed_data();
  const int32_t* in = init.typed_data();
  const int32_t* a = adj.typed_data();
  const uint32_t* r = rows.typed_data();
  int32_t* k = keys->typed_data();
  int32_t* v = vis->typed_data();
  int32_t* s = steps->typed_data();
  const cudaError_t err = launch<32>(stream, q, in, a, r, k, v, s, B, cap, W, CP, ef,
                                     id_bits, max_d, max_steps);
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(HnswBeamSearch, BeamSearchImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("ef")
                                  .Attr<int32_t>("id_bits")
                                  .Attr<int32_t>("max_d")
                                  .Attr<int32_t>("max_steps"));
