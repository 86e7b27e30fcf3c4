// The random draw tables of the K-stage DAG event loop.
//
// Replaces: the eager torch body of kernels/dag_event/ref.py dag_streams,
// the counterpart of the tables the reference's _dag_sim draws before its
// lax.scan (src/repro/core/dag.py:91-131; XLA computes them, no Pallas
// kernel maps to them).  Per lane, with key = (0, seed mod 2^32) and
// (k0, kf) = split(key) -- the DAG keeps the second half as its fold key
// where the MapReduce simulator discards it -- it writes:
//   think0[b, h] = exponential(k0, (H,))[h] * think_ms[b]
//   st[b, i]: from key_i = fold_in(kf, i), in replay mode the int32 index
//       randint(key_i, (), 0, n_samples) (the two words of split(key_i)
//       reduced modulo n_samples; the loop gathers the sample by the
//       user's current stage), otherwise the bits of one float32 unit
//       exponential (the loop scales it by the stage mean)
//   td[b, i] = exponential(fold_in(kf, i + n_events_active[b]))
// with jax.random's threefry2x32 (threefry.cuh); the think product is
// rounded on its own, as the reference's.
//
// What bounds it on the H100: the integer pipe (a threefry's 20 rotates
// and 20 xors and two more xors; its adds issue mostly as IMAD on the FMA
// pipe), a few times the time to write the tables: 4 threefries an event
// in exponential mode (key_i and its bits, the think key and its bits), 7
// in replay mode (the two halves of split(key_i) and their bits in place
// of key_i's bits), one a user, two a lane (split(key)).  At the main
// path's sizes (16 lanes of 8192 events) that is about 1.3 us of integer
// work, near the card's launch floor, so the design is aimed at doing the
// counted work and no more, in one launch:
//   - the lane keys split(key) are derived once per lane and block, by one
//     thread each, into shared memory (not once per table entry);
//   - a thread draws a run of kRun = 2 consecutive events (or users) of
//     one lane, the runs independent of each other, and stores each table's
//     run as one 8-byte store where the row is aligned for it (runs of 4
//     with 16-byte stores, and of 1, lost an A/B on the H100 at the main
//     path's shape: PERF.md §6);
//   - the grid is sized to the card's SMs (as many blocks as are resident
//     at once), each block walking tiles of 256 runs.
// The three tables are one allocation, [st | td | think0] in 32-bit words
// (kernels/dag_event/ops.py cuts the views), so that a call allocates once.
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 2;          // consecutive events (or users) a thread

// One event's draws in exponential mode: the unit service draw's bits and
// the think draw (4 threefries).
__device__ __forceinline__ void exponential_event(unsigned f0, unsigned f1,
                                                  unsigned i, unsigned i_td,
                                                  unsigned& st, float& td) {
  unsigned k0, k1;
  derive(f0, f1, i, k0, k1);                         // key_i
  st = __float_as_uint(unit_exponential(bits_at(k0, k1, 0u)));
  derive(f0, f1, i_td, k0, k1);                      // the think key
  td = unit_exponential(bits_at(k0, k1, 0u));
}

// One event's draws in replay mode: the sample index randint(key_i) and
// the think draw (7 threefries).
__device__ __forceinline__ void replay_event(unsigned f0, unsigned f1,
                                             unsigned i, unsigned i_td,
                                             int n_samples, unsigned& st,
                                             float& td) {
  unsigned k0, k1, a0, a1, c0, c1;
  derive(f0, f1, i, k0, k1);                         // key_i
  derive(k0, k1, 0u, a0, a1);                        // split(key_i)
  derive(k0, k1, 1u, c0, c1);
  st = randint(bits_at(a0, a1, 0u), bits_at(c0, c1, 0u), n_samples);
  derive(f0, f1, i_td, k0, k1);                      // the think key
  td = unit_exponential(bits_at(k0, k1, 0u));
}

// A run of kRun 32-bit words at p: one vector store where the run is whole
// and its row aligned for it (`whole`), else word by word, the first n.
__device__ __forceinline__ void store_run(unsigned* p,
                                          const unsigned (&v)[kRun], int n,
                                          bool whole) {
  if constexpr (kRun == 4) {
    if (whole) {
      *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else if constexpr (kRun == 2) {
    if (whole) {
      *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < kRun; ++r)
    if (r < n) p[r] = v[r];
}

// tables: B * (2E + H) words, [st | td | think0]; vec's bits: the event
// tables' rows (bit 0) and think0's rows (bit 1) take a whole run as one
// vector store.  A thread's kRun draws are computed unconditionally (a
// ragged run's extra draws are not stored), so that they stay one
// straight-line block whose independent threefry chains interleave.
template <bool REPLAY>
__global__ void __launch_bounds__(kThreads) dag_streams_kernel(
    const long long* __restrict__ seed, const int* __restrict__ n_active,
    const float* __restrict__ think_ms, unsigned* __restrict__ tables,
    int B, int H, int E, int n_samples, int vec) {
  __shared__ uint4 s_key[kThreads];     // a lane's (k0, k1, kf0, kf1)
  __shared__ int s_nea[kThreads];
  __shared__ float s_think[kThreads];
  unsigned* const st = tables;
  unsigned* const td = tables + (size_t)B * E;
  unsigned* const think0 = tables + 2 * (size_t)B * E;
  const int runs_e = (E + kRun - 1) / kRun;
  const int runs = runs_e + (H + kRun - 1) / kRun;   // a lane's runs
  const long long n_runs = (long long)B * runs;
  for (long long g0 = (long long)blockIdx.x * kThreads; g0 < n_runs;
       g0 += (long long)gridDim.x * kThreads) {
    // the lanes this tile of runs touches (at most kThreads: runs >= 1)
    const int lane0 = (int)(g0 / runs);
    const long long g_end = g0 + kThreads < n_runs ? g0 + kThreads : n_runs;
    const int n_lanes = (int)((g_end - 1) / runs) - lane0 + 1;
    __syncthreads();                    // the last tile's reads are done
    if ((int)threadIdx.x < n_lanes) {
      const int b = lane0 + threadIdx.x;
      const unsigned s = (unsigned)seed[b];
      uint4 k;
      derive(0u, s, 0u, k.x, k.y);      // split(key)[0]: the think key
      derive(0u, s, 1u, k.z, k.w);      // split(key)[1]: the fold key
      s_key[threadIdx.x] = k;
      s_nea[threadIdx.x] = n_active[b];
      s_think[threadIdx.x] = think_ms[b];
    }
    __syncthreads();
    const long long g = g0 + threadIdx.x;
    if (g >= n_runs) continue;
    const int b = (int)(g / runs);
    const int j = (int)(g - (long long)b * runs);
    const uint4 k = s_key[b - lane0];
    if (j < runs_e) {                   // events i0 .. i0 + kRun - 1
      const int i0 = j * kRun;
      const unsigned nea = (unsigned)s_nea[b - lane0];
      unsigned sv[kRun], tv[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const unsigned i = (unsigned)(i0 + r);
        float t;
        if constexpr (REPLAY)
          replay_event(k.z, k.w, i, i + nea, n_samples, sv[r], t);
        else
          exponential_event(k.z, k.w, i, i + nea, sv[r], t);
        tv[r] = __float_as_uint(t);
      }
      const size_t at = (size_t)b * E + i0;
      const bool whole = (vec & 1) && i0 + kRun <= E;
      store_run(st + at, sv, E - i0, whole);
      store_run(td + at, tv, E - i0, whole);
    } else {                            // users h0 .. h0 + kRun - 1
      const int h0 = (j - runs_e) * kRun;
      const float tm = s_think[b - lane0];
      unsigned v[kRun];
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        v[r] = __float_as_uint(__fmul_rn(
            unit_exponential(bits_at(k.x, k.y, (unsigned)(h0 + r))), tm));
      store_run(think0 + (size_t)b * H + h0, v, H - h0,
                (vec & 2) && h0 + kRun <= H);
    }
  }
}

// As many blocks of `kernel` as the card holds at once (its SMs times the
// blocks an SM keeps resident), looked up once per device and instance.
template <bool REPLAY>
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dag_streams_kernel<REPLAY>, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// seed int64 (B,), n_active int32 (B,), think_ms float32 (B,); tables: one
// allocation of B * (2E + H) 32-bit words, written as st (B, E) (int32
// sample indices in replay mode, float32 unit draws otherwise), then td
// float32 (B, E), then think0 float32 (B, H), each contiguous.  n_samples
// is the replay lists' length (unused in exponential mode).
extern "C" int dag_streams_launch(const long long* seed, const int* n_active,
                                  const float* think_ms, unsigned* tables,
                                  int B, int H, int E, int n_samples,
                                  int replay, void* stream) {
  const long long runs = (long long)B * ((E + kRun - 1) / kRun +
                                         (H + kRun - 1) / kRun);
  if (runs <= 0) return (int)cudaGetLastError();
  const auto aligned = [](const unsigned* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * kRun) == 0;
  };
  const size_t n = (size_t)B * E;
  const int vec =
      (E % kRun == 0 && aligned(tables) && aligned(tables + n) ? 1 : 0) |
      (H % kRun == 0 && aligned(tables + 2 * n) ? 2 : 0);
  const int most = replay ? resident_blocks<true>() : resident_blocks<false>();
  if (most <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (runs + kThreads - 1) / kThreads;
  const int grid = (int)(tiles < most ? tiles : most);
  const cudaStream_t s = (cudaStream_t)stream;
  if (replay)
    dag_streams_kernel<true><<<grid, kThreads, 0, s>>>(
        seed, n_active, think_ms, tables, B, H, E, n_samples, vec);
  else
    dag_streams_kernel<false><<<grid, kThreads, 0, s>>>(
        seed, n_active, think_ms, tables, B, H, E, n_samples, vec);
  return (int)cudaGetLastError();
}
