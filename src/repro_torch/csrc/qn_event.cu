// Fused event loop of the closed fork-join queueing network, one simulator
// lane (candidate x replication) per warp.
//
// Replaces: src/repro/kernels/qn_event/kernel.py, qn_event_fwd /
// _event_kernel -- the Pallas kernel that steps a block of 8 lanes through
// n_events events with every selection vectorized over the lanes.
//
// Each step does exactly one of: dispatch one queued task (reduce tasks
// first, FIFO by stage arrival, into the first free slot); complete the
// earliest-ending task (a finished map stage forks the reduces, a finished
// reduce stage ends the job and starts a think); or end the earliest think
// (submit a job: fork its maps).  The random draws arrive as per-lane
// tables (row i is read at step i), so the kernel itself is RNG-free.
//
// What bounds it on the H100: not bytes (the draw tables are read once,
// 12 bytes per event) and not operations (about 3*S + 8*H compares and
// selects per event), but the chain of dependent steps inside each lane:
// step i+1 needs the state step i wrote.  Lanes are independent, so the
// design gives each lane one warp and keeps the steps short:
//   * the lane's state lives in shared memory (slot clocks and owners,
//     S = max_slots of each; six per-user arrays of H), or in a global
//     scratch slice when it does not fit in 48 KB;
//   * every step's selections (first free slot, earliest slot end,
//     earliest think end, oldest reduce / map arrival) are one pass of the
//     32 threads over the arrays, then warp-shuffle reductions on
//     (value, index) pairs that break ties toward the smaller index, as
//     jnp.argmin / argmax do;
//   * thread 0 applies the step's scalar updates; __syncwarp() orders the
//     phases;
//   * the draw tables are loaded 32 events at a time (one per thread) and
//     broadcast with __shfl_sync, so no step waits on device memory;
//   * steps at or past the lane's logical budget are no-ops in the
//     reference, so the loop simply ends there.
//
// Rounding matches the reference bit for bit: XLA contracts
// now + e*mean and t_slot + e*think into FMAs, written here as __fmaf_rn;
// everything else is adds, compares and selects; the file is built with
// --fmad=false.  INF is the finite sentinel 1e30, as in the reference.
#include <cuda_runtime.h>
#include <climits>

#define QN_INF 1e30f
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(FULL_MASK, v, off);
    int i2 = __shfl_xor_sync(FULL_MASK, i, off);
    argmin_merge(v, i, v2, i2);
  }
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__global__ void __launch_bounds__(32) qn_event_kernel(
    const int* __restrict__ n_map, const int* __restrict__ n_reduce,
    const int* __restrict__ slots_cap, const int* __restrict__ n_active,
    const float* __restrict__ m_avg, const float* __restrict__ r_avg,
    const float* __restrict__ think_ms, const float* __restrict__ think0,
    const float* __restrict__ st_m, const float* __restrict__ st_r,
    const float* __restrict__ td, float* __restrict__ resp_sum_out,
    float* __restrict__ resp_cnt_out, float* g_slot_end, int* g_slot_user,
    int H, int S, int n_events, int warmup_jobs, int replay) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);

  float* think_end = smem;
  float* arrival = smem + H;
  float* job_start = smem + 2 * H;
  int* phase = (int*)(smem + 3 * H);
  int* pending = phase + H;
  int* inflight = phase + 2 * H;
  float* slot_end;
  int* slot_user;
  if (g_slot_end == nullptr) {
    slot_end = smem + 6 * H;
    slot_user = (int*)(slot_end + S);
  } else {
    slot_end = g_slot_end + (size_t)lane * S;
    slot_user = g_slot_user + (size_t)lane * S;
  }

  const int nm = n_map[lane], nr = n_reduce[lane], cap = slots_cap[lane];
  const float ma = m_avg[lane], ra = r_avg[lane], tm = think_ms[lane];
  const int steps = min(n_events, n_active[lane]);
  for (int s = t; s < S; s += 32) {
    slot_end[s] = QN_INF;
    slot_user[s] = -1;
  }
  for (int h = t; h < H; h += 32) {
    think_end[h] = think0[(size_t)lane * H + h];
    arrival[h] = QN_INF;
    job_start[h] = 0.0f;
    phase[h] = 0;
    pending[h] = 0;
    inflight[h] = 0;
  }
  __syncwarp();

  const float* row_m = st_m + (size_t)lane * n_events;
  const float* row_r = st_r + (size_t)lane * n_events;
  const float* row_t = td + (size_t)lane * n_events;
  float c_m = 0.0f, c_r = 0.0f, c_t = 0.0f;
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  int done_jobs = 0;

  for (int i = 0; i < steps; ++i) {
    const int j = i & 31;
    if (j == 0) {
      const int k = i + t;
      if (k < n_events) {
        c_m = row_m[k];
        c_r = row_r[k];
        c_t = row_t[k];
      }
    }
    const float stm_i = __shfl_sync(FULL_MASK, c_m, j);
    const float str_i = __shfl_sync(FULL_MASK, c_r, j);
    const float td_i = __shfl_sync(FULL_MASK, c_t, j);

    // ---- selections: one pass over users and slots, then warp reductions
    float red_v = inf, map_v = inf, thk_v = inf, end_v = inf;
    int red_i = INT_MAX, map_i = INT_MAX, thk_i = INT_MAX, end_i = INT_MAX;
    int first_free = INT_MAX, any_pending = 0;
    for (int h = t; h < H; h += 32) {
      const int p = pending[h], ph = phase[h];
      const float arr = arrival[h];
      argmin_merge(red_v, red_i, (p > 0 && ph == 2) ? arr : QN_INF, h);
      argmin_merge(map_v, map_i, (p > 0 && ph == 1) ? arr : QN_INF, h);
      argmin_merge(thk_v, thk_i, think_end[h], h);
      any_pending |= (p > 0);
    }
    for (int s = t; s < S; s += 32) {
      argmin_merge(end_v, end_i, slot_end[s], s);
      if (s < cap && slot_user[s] < 0 && s < first_free) first_free = s;
    }
    warp_argmin(red_v, red_i);
    warp_argmin(map_v, map_i);
    warp_argmin(thk_v, thk_i);
    warp_argmin(end_v, end_i);
    first_free = warp_min(first_free);
    any_pending = __any_sync(FULL_MASK, any_pending);
    __syncwarp();

    // ---- thread 0 applies the one event of this step
    if (t == 0) {
      const float t_slot = end_v, t_think = thk_v;
      if (first_free != INT_MAX && any_pending) {            // dispatch
        const int u = red_v < QN_INF ? red_i : map_i;
        const bool is_map = phase[u] == 1;
        slot_end[first_free] =
            replay ? __fadd_rn(now, is_map ? stm_i : str_i)
                   : __fmaf_rn(stm_i, is_map ? ma : ra, now);
        slot_user[first_free] = u;
        pending[u] -= 1;
        inflight[u] += 1;
      } else if (t_slot <= t_think && t_slot < QN_INF) {    // completion
        const int cs = end_i;
        const int cu = slot_user[cs];
        const int infl = inflight[cu] - 1;
        const bool stage_done = pending[cu] == 0 && infl == 0;
        const bool was_map = phase[cu] == 1;
        inflight[cu] = infl;
        if (stage_done && was_map) {         // map stage done: fork reduces
          phase[cu] = 2;
          pending[cu] = nr;
          arrival[cu] = t_slot;
        } else if (stage_done) {             // reduce stage done: job done
          phase[cu] = 0;
          arrival[cu] = QN_INF;
          think_end[cu] = __fmaf_rn(td_i, tm, t_slot);
          if (done_jobs >= warmup_jobs) {
            resp_sum = __fadd_rn(resp_sum, __fsub_rn(t_slot, job_start[cu]));
            resp_cnt = __fadd_rn(resp_cnt, 1.0f);
          }
          done_jobs += 1;
        }
        slot_end[cs] = QN_INF;
        slot_user[cs] = -1;
        now = t_slot;
      } else if (t_think < QN_INF) {                         // think end
        const int tu = thk_i;
        phase[tu] = 1;
        pending[tu] = nm;
        arrival[tu] = t_think;
        job_start[tu] = t_think;
        think_end[tu] = QN_INF;
        now = t_think;
      }
    }
    __syncwarp();
  }
  if (t == 0) {
    resp_sum_out[lane] = resp_sum;
    resp_cnt_out[lane] = resp_cnt;
  }
}

extern "C" int qn_event_launch(
    const int* n_map, const int* n_reduce, const int* slots_cap,
    const int* n_active, const float* m_avg, const float* r_avg,
    const float* think_ms, const float* think0, const float* st_m,
    const float* st_r, const float* td, float* resp_sum, float* resp_cnt,
    float* g_slot_end, int* g_slot_user, int lanes, int h_users,
    int max_slots, int n_events, int warmup_jobs, int replay, void* stream) {
  if (lanes > 0) {
    size_t smem = 6 * sizeof(float) * (size_t)h_users;
    if (g_slot_end == nullptr) smem += 2 * sizeof(float) * (size_t)max_slots;
    qn_event_kernel<<<lanes, 32, smem, (cudaStream_t)stream>>>(
        n_map, n_reduce, slots_cap, n_active, m_avg, r_avg, think_ms, think0,
        st_m, st_r, td, resp_sum, resp_cnt, g_slot_end, g_slot_user, h_users,
        max_slots, n_events, warmup_jobs, replay);
  }
  return (int)cudaGetLastError();
}
