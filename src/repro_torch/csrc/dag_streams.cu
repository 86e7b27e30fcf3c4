// The random draw tables of the K-stage DAG event loop, one thread per
// table entry.
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
// pipe), a few times the time to write the tables: 5 threefries an event
// in exponential mode (the fold key, key_i and its bits, the think key and
// its bits), 8 in replay mode (the two halves of split(key_i) and their
// bits in place of key_i's bits).  Each thread computes one entry
// independently of the others, so the grid covers every entry at once.
#include <cstdint>

#include "threefry.cuh"

namespace {

__global__ void __launch_bounds__(256) dag_streams_kernel(
    const long long* __restrict__ seed, const int* __restrict__ n_active,
    const float* __restrict__ think_ms, float* __restrict__ think0,
    unsigned* __restrict__ st, float* __restrict__ td, int B, int H, int E,
    int n_samples, int replay) {
  const long long n_event = (long long)B * E;
  const long long n_all = n_event + (long long)B * H;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < n_all; g += (long long)gridDim.x * blockDim.x) {
    if (g < n_event) {
      const int b = (int)(g / E);
      const unsigned i = (unsigned)(g - (long long)b * E);
      unsigned f0, f1, k0, k1;
      derive(0u, (unsigned)seed[b], 1u, f0, f1);     // split(key)[1]
      derive(f0, f1, i, k0, k1);                     // key_i
      if (replay) {
        unsigned a0, a1, c0, c1;
        derive(k0, k1, 0u, a0, a1);                  // split(key_i)
        derive(k0, k1, 1u, c0, c1);
        st[g] = randint(bits_at(a0, a1, 0u), bits_at(c0, c1, 0u),
                        n_samples);
      } else {
        st[g] = __float_as_uint(unit_exponential(bits_at(k0, k1, 0u)));
      }
      derive(f0, f1, i + (unsigned)n_active[b], k0, k1);
      td[g] = unit_exponential(bits_at(k0, k1, 0u));
    } else {
      const long long q = g - n_event;
      const int b = (int)(q / H);
      const unsigned h = (unsigned)(q - (long long)b * H);
      unsigned k0, k1;
      derive(0u, (unsigned)seed[b], 0u, k0, k1);    // split(key)[0]
      think0[q] = __fmul_rn(unit_exponential(bits_at(k0, k1, h)),
                            think_ms[b]);
    }
  }
}

}  // namespace

// seed int64 (B,), n_active int32 (B,), think_ms float32 (B,); outputs
// think0 float32 (B, H), st (B, E) (int32 sample indices in replay mode,
// float32 unit draws otherwise; written as 32-bit words) and td float32
// (B, E), contiguous.  n_samples is the replay lists' length (unused in
// exponential mode).
extern "C" int dag_streams_launch(const long long* seed, const int* n_active,
                                  const float* think_ms, float* think0,
                                  unsigned* st, float* td, int B, int H,
                                  int E, int n_samples, int replay,
                                  void* stream) {
  const long long n_all = (long long)B * E + (long long)B * H;
  if (n_all > 0) {
    const long long blocks = (n_all + 255) / 256;
    const int grid = (int)(blocks < 1048576 ? blocks : 1048576);
    dag_streams_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        seed, n_active, think_ms, think0, st, td, B, H, E, n_samples,
        replay);
  }
  return (int)cudaGetLastError();
}
