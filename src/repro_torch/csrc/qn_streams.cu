// The random draw tables of the QN event loop, one thread per table entry.
//
// Replaces: the eager torch body of kernels/qn_event/ref.py event_streams
// (the counterpart of the reference's kernels/qn_event/kernel.py
// event_streams, which XLA fuses; no Pallas kernel maps to it).  Per lane
// (key = (0, seed mod 2^32)) it writes:
//   think0[b, h] = exponential(split(key)[0], (H,))[h] * think_ms[b]
//   st_m[b, i], st_r[b, i]: from key_i = fold_in(key, i), one unit
//       exponential (both tables), or in replay mode the two randint words
//       of split(key_i) reduced modulo each list's length, then gathered
//   td[b, i] = exponential(fold_in(key, i + n_events_active[b]))
// with jax.random's threefry2x32 (20 rounds, the partitionable counter
// scheme: counter (0, index), output word 0 xor word 1).  All of it is
// uint32 arithmetic, exact; a uniform is the top 23 bits under 1.0's
// exponent minus 1.0 (exact), an exponential -log1pf(-u) as torch's
// log1p computes it on the card; the think product is rounded on its own.
//
// What bounds it on the H100: the integer pipe (a threefry's 20 rotates
// and 20 xors, and two more xors, there; its adds issue mostly as IMAD on
// the FMA pipe; 4 threefries an event in exponential mode, 7 in replay
// mode), a few times the time to write the tables.  Each thread computes one entry
// independently of the others, so the grid covers every entry at once.
#include <cstdint>

#include "threefry.cuh"

namespace {

__global__ void __launch_bounds__(256) qn_streams_kernel(
    const long long* __restrict__ seed, const int* __restrict__ n_active,
    const float* __restrict__ think_ms, const float* __restrict__ m_list,
    const float* __restrict__ r_list, float* __restrict__ think0,
    float* __restrict__ st_m, float* __restrict__ st_r,
    float* __restrict__ td, int B, int H, int E, int n_m, int n_r,
    int replay) {
  const long long n_event = (long long)B * E;
  const long long n_all = n_event + (long long)B * H;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < n_all; g += (long long)gridDim.x * blockDim.x) {
    if (g < n_event) {
      const int b = (int)(g / E);
      const unsigned i = (unsigned)(g - (long long)b * E);
      const unsigned s = (unsigned)seed[b];
      unsigned k0, k1;
      derive(0u, s, i, k0, k1);                      // key_i
      if (replay) {
        unsigned a0, a1, c0, c1;
        derive(k0, k1, 0u, a0, a1);                  // split(key_i)
        derive(k0, k1, 1u, c0, c1);
        const unsigned hi = bits_at(a0, a1, 0u), lo = bits_at(c0, c1, 0u);
        st_m[g] = m_list[randint(hi, lo, n_m)];
        st_r[g] = r_list[randint(hi, lo, n_r)];
      } else {
        st_m[g] = unit_exponential(bits_at(k0, k1, 0u));
      }
      derive(0u, s, i + (unsigned)n_active[b], k0, k1);
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

// seed int64 (B,), n_active int32 (B,), think_ms float32 (B,); the sample
// lists (replay mode) float32 (n_m,) and (n_r,); outputs think0 (B, H) and
// st_m, st_r, td (B, E), float32, contiguous.  In exponential mode st_r is
// not written (the unit draws are st_m's).
extern "C" int qn_streams_launch(
    const long long* seed, const int* n_active, const float* think_ms,
    const float* m_list, const float* r_list, float* think0, float* st_m,
    float* st_r, float* td, int B, int H, int E, int n_m, int n_r,
    int replay, void* stream) {
  const long long n_all = (long long)B * E + (long long)B * H;
  if (n_all > 0) {
    const long long blocks = (n_all + 255) / 256;
    const int grid = (int)(blocks < 1048576 ? blocks : 1048576);
    qn_streams_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        seed, n_active, think_ms, m_list, r_list, think0, st_m, st_r, td, B,
        H, E, n_m, n_r, replay);
  }
  return (int)cudaGetLastError();
}
