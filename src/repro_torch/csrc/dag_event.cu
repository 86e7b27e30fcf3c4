// Fused event loop of the closed K-stage fork-join chain (a Tez/Spark DAG
// job: stage k forks into n_k tasks that share the slots), one simulator
// lane (candidate x replication) per warp.
//
// Replaces: src/repro/core/dag.py, _dag_sim -- the reference has no Pallas
// kernel for the DAG: its step is a lax.scan over events that XLA compiles
// into a device loop (the eager torch version of that step costs ~75
// launches an event).
//
// Each step does exactly one of: dispatch one queued task (the deepest
// stage first -- the paper's class-switch priority -- FIFO by the stage's
// arrival within a depth, the lower user on ties, into the first free
// slot); complete the earliest-ending task (a finished stage forks the
// next one, the last stage ends the job and starts a think); or end the
// earliest think (submit a job: fork stage 1).  The draws arrive as
// per-lane tables (row i is read at step i), so the loop is RNG-free.
//
// What bounds it on the H100: as qn_event (csrc/qn_event.cu), not bytes (8
// bytes an event of tables) and not operations, but the chain of
// dependent steps inside each lane: a launch takes the latency of one step
// times the number of events.  The layout is qn_event_general's (any H,
// any slot count, any K):
//   * the lane's slots_cap slots (event_loop.cuh Slots) and its H users
//     are cut into 32 contiguous blocks, one a thread; only the owner of a
//     block writes it, and it keeps its block's minima in registers: the
//     earliest slot end (with its user), the first free slot, the earliest
//     think end, and the first queued user in the queue order;
//   * a step changes at most one slot and one user, so only their owners'
//     minima move: in O(1) when a key falls, by a rescan of the one block
//     when the minimum leaves;
//   * the state lives in dynamic shared memory, opt-in above 48 KB, or
//     past the card's shared memory in a global scratch slice per lane;
//   * the queue order is a 64-bit key: (0x7fffffff - stage) above the
//     arrival's clock key, so the deepest stage, then the earliest arrival,
//     sorts first; the warp takes it in two 32-bit reductions (the stage
//     word, then the arrival among the lanes at that stage), and a ballot
//     with __ffs names the lowest lane holding it, whose block's first
//     minimum is the first user, as jnp.argmin breaks ties;
//   * the draw tables are prefetched 32 events ahead (one per thread) and
//     broadcast with __shfl_sync; steps at or past the lane's logical
//     budget are no-ops in the reference, so the loop ends there.
// Stage arrays are padded to a bucket of K; each lane clips its stage
// indices to its own n_stages, as the reference does.
//
// Rounding matches the reference bit for bit: XLA contracts now + e*mean
// (exponential mode) and t_slot + e*think into FMAs, written here as
// __fmaf_rn; replay mode adds a gathered sample (__fadd_rn); the response
// sum uses __fsub_rn / __fadd_rn; everything else is compares and
// selects; the file is built with --fmad=false.
#include "event_loop.cuh"

namespace {

constexpr unsigned long long kNoQueue = ~0ull;

// The draw tables of one lane, read 32 events ahead: thread t holds event
// 32*b + t of the current block b and of the next.  The service table holds
// 32-bit words: an int32 sample index (replay) or a float32 unit draw.
struct DagDraws {
  const unsigned* s;
  const float* d;
  int n;
  unsigned c_s = 0u, n_s = 0u;
  float c_t = 0.0f, n_t = 0.0f;

  __device__ void init(const unsigned* st, const float* td, int lane,
                       int n_events, int t) {
    s = st + (size_t)lane * n_events;
    d = td + (size_t)lane * n_events;
    n = n_events;
    if (n > 0) fetch(t);
  }

  __device__ __forceinline__ void fetch(int k) {
    k = min(k, n - 1);
    n_s = s[k];
    n_t = d[k];
  }

  // step i's draws, on every thread
  __device__ __forceinline__ void at(int i, int t, unsigned& sv, float& tdv) {
    const int j = i & 31;
    if (j == 0) {
      c_s = n_s;
      c_t = n_t;
      fetch(i + 32 + t);
    }
    sv = __shfl_sync(FULL_MASK, c_s, j);
    tdv = __shfl_sync(FULL_MASK, c_t, j);
  }
};

// This thread's users, global indices [base, base + n), six arrays at
// stride uw.  A user's queue key is its stage's arrival while it has tasks
// pending, kNone otherwise; its think key is the think end.  Arrival and
// think end are read through their keys only.
struct DagUsers {
  unsigned *pkey, *tkey;
  int *phase, *pending, *inflight;
  float* job_start;
  int base, n, bu;
  unsigned long long p_min;   // the block's first user in the queue order
  int p_loc;
  unsigned t_min;
  int t_loc;

  __device__ void init(unsigned* region, int t, int uw, int H,
                       const float* think0) {
    bu = max((H + 31) / 32, 1);
    base = t * bu;
    n = min(max(H - base, 0), bu);
    const size_t stride = 32 * (size_t)uw, off = (size_t)t * uw;
    pkey = region + off;
    tkey = region + stride + off;
    phase = (int*)(region + 2 * stride) + off;
    pending = (int*)(region + 3 * stride) + off;
    inflight = (int*)(region + 4 * stride) + off;
    job_start = (float*)(region + 5 * stride) + off;
    for (int l = 0; l < n; ++l) {
      pkey[l] = kNone;
      tkey[l] = clock_key(think0[base + l]);
      phase[l] = pending[l] = inflight[l] = 0;
      job_start[l] = 0.0f;
    }
    p_min = kNoQueue;
    p_loc = 0;
    rescan_think();
  }

  // (0x7fffffff - stage, arrival key): the deepest stage first, then the
  // earliest arrival
  __device__ __forceinline__ unsigned long long queue_key(int l) const {
    const unsigned a = pkey[l];
    return a == kNone ? kNoQueue
                      : ((unsigned long long)(0x7fffffffu - (unsigned)phase[l])
                         << 32) | a;
  }

  __device__ __forceinline__ void rescan_queue() {
    unsigned long long m = kNoQueue;
    int loc = 0;
    for (int l = 0; l < n; ++l) {
      const unsigned long long x = queue_key(l);
      if (x < m) {
        m = x;
        loc = l;
      }
    }
    p_min = m;
    p_loc = loc;
  }

  __device__ __forceinline__ void rescan_think() {
    unsigned m = kNone;
    int loc = 0;
    for (int l = 0; l < n; ++l) {
      const unsigned x = tkey[l];
      if (x < m) {
        m = x;
        loc = l;
      }
    }
    t_min = m;
    t_loc = loc;
  }

  // user l's stage starts queued at `clock` with `tasks` tasks
  __device__ __forceinline__ void enqueue(int l, float clock, int tasks) {
    pending[l] = tasks;
    pkey[l] = tasks > 0 ? clock_key(clock) : kNone;
    const unsigned long long k = queue_key(l);
    if (k < p_min || (k == p_min && l < p_loc)) {
      p_min = k;
      p_loc = l;
    }
  }

  // the first queued user sends one task to a slot
  __device__ __forceinline__ void dispatch() {
    const int l = p_loc;
    const int p = pending[l] - 1;
    pending[l] = p;
    inflight[l] += 1;
    if (p == 0) {
      pkey[l] = kNone;
      rescan_queue();
    }
  }

  // a task of global user u completed at t_slot; returns true when its job
  // ended (then *resp is its response time)
  __device__ __forceinline__ bool complete(int u, float t_slot, float td,
                                           float tm, int ns, int K,
                                           const int* n_tasks, float* resp) {
    const int l = u - base;
    const int infl = inflight[l] - 1;
    inflight[l] = infl;
    if (pending[l] != 0 || infl != 0) return false;
    const int ph = phase[l];
    if (ph < ns) {                  // stage done: fork the next one
      phase[l] = ph + 1;
      enqueue(l, t_slot, n_tasks[min(max(ph, 0), K - 1)]);
      return false;
    }
    // the last stage is done: the job ends and a think starts
    const unsigned k = clock_key(__fmaf_rn(td, tm, t_slot));
    phase[l] = 0;
    tkey[l] = k;
    if (k < t_min || (k == t_min && l < t_loc)) {
      t_min = k;
      t_loc = l;
    }
    *resp = __fsub_rn(t_slot, job_start[l]);
    return true;
  }

  // the earliest think ends at t_think: the user submits a job (stage 1)
  __device__ __forceinline__ void think(float t_think, int tasks) {
    const int l = t_loc;
    phase[l] = 1;
    job_start[l] = t_think;
    tkey[l] = clock_key(QN_INF);
    rescan_think();
    enqueue(l, t_think, tasks);
  }
};

__global__ void __launch_bounds__(32) dag_event_kernel(
    const int* __restrict__ n_tasks, const float* __restrict__ t_avg,
    const int* __restrict__ n_stages, const int* __restrict__ slots_cap,
    const int* __restrict__ n_active, const float* __restrict__ think_ms,
    const float* __restrict__ think0, const unsigned* __restrict__ st,
    const float* __restrict__ td, const float* __restrict__ samples,
    float* __restrict__ resp_sum_out, float* __restrict__ resp_cnt_out,
    unsigned* scratch, size_t scratch_words, int K, int H, int S, int sw,
    int nwords, int uw, int n_events, int n_samples, int sample_rows,
    int warmup_jobs, int replay) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  unsigned* region =
      scratch == nullptr ? smem : scratch + (size_t)lane * scratch_words;
  const unsigned k_inf = clock_key(QN_INF);

  const int* nt = n_tasks + (size_t)lane * K;
  const float* ta = t_avg + (size_t)lane * K;
  const int ns = n_stages[lane];
  const int cap = min(max(slots_cap[lane], 0), S);
  const float tm = think_ms[lane];
  const int steps = max(0, min(n_events, n_active[lane]));

  Slots slots;
  slots.init(region, t, sw, nwords, cap);
  DagUsers users;
  users.init(region + 64 * (size_t)sw + 32 * (size_t)nwords, t, uw, H,
             think0 + (size_t)lane * H);
  DagDraws draws;
  draws.init(st, td, lane, n_events, t);
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  int done_jobs = 0;

  for (int i = 0; i < steps; ++i) {
    unsigned st_i;
    float td_i;
    draws.at(i, t, st_i, td_i);
    const unsigned adv = advance_key(slots.min_key, users.t_min);
    const unsigned q_hi = (unsigned)(users.p_min >> 32);
    const unsigned g_free = __reduce_min_sync(FULL_MASK, slots.free_key());
    const unsigned g_hi = __reduce_min_sync(FULL_MASK, q_hi);
    const unsigned g_adv = __reduce_min_sync(FULL_MASK, adv);

    if (g_free != kNone && g_hi != kNone) {                 // dispatch
      const unsigned q_lo = (unsigned)users.p_min;
      const unsigned g_lo =
          __reduce_min_sync(FULL_MASK, q_hi == g_hi ? q_lo : kNone);
      const int wu =
          __ffs(__ballot_sync(FULL_MASK, q_hi == g_hi && q_lo == g_lo)) - 1;
      const int u = __shfl_sync(FULL_MASK, users.base + users.p_loc, wu);
      // clip(stage - 1, 0, n_stages - 1); its gathers clamp to the rows
      // there are, as the reference's do
      const int depth = (int)(0x7fffffffu - g_hi);
      const int stage = max(min(max(depth - 1, 0), ns - 1), 0);
      const size_t row = (size_t)min(stage, sample_rows - 1);
      const float end =
          replay ? __fadd_rn(now, samples[row * n_samples + st_i])
                 : __fmaf_rn(__uint_as_float(st_i), ta[min(stage, K - 1)],
                             now);
      if (t == wu) users.dispatch();
      if (slots.free_key() == g_free) slots.dispatch(end, u);
      continue;
    }
    const unsigned ka = g_adv >> 1;
    if (ka >= k_inf) continue;                              // nothing left
    const float clock = key_clock(ka);
    const int w = __ffs(__ballot_sync(FULL_MASK, adv == g_adv)) - 1;
    if ((g_adv & 1u) == 0) {                                // completion
      const int cu = __shfl_sync(FULL_MASK, slots.min_user, w);
      if (t == w) slots.complete();
      const int wc = cu / users.bu;
      float resp = 0.0f;
      bool job_done = false;
      if (t == wc)
        job_done = users.complete(cu, clock, td_i, tm, ns, K, nt, &resp);
      if (__ballot_sync(FULL_MASK, job_done)) {
        resp = __shfl_sync(FULL_MASK, resp, wc);
        if (done_jobs >= warmup_jobs) {
          resp_sum = __fadd_rn(resp_sum, resp);
          resp_cnt = __fadd_rn(resp_cnt, 1.0f);
        }
        done_jobs += 1;
      }
    } else if (t == w) {                                    // think end
      users.think(clock, nt[0]);
    }
    now = clock;
  }
  if (t == 0) {
    resp_sum_out[lane] = resp_sum;
    resp_cnt_out[lane] = resp_cnt;
  }
}

// Where a lane's state lives, in 32-bit words: slot keys and users (32
// blocks of sw), free-mask words (32 x nwords) and six per-user arrays (32
// blocks of uw); in dynamic shared memory when it fits the card's opt-in
// limit, else in a global scratch slice per lane.
struct Plan {
  int sw, nwords, uw;
  size_t words;
  bool in_smem;
};

int plan(int h_users, int max_slots, Plan* p) {
  p->sw = ((max_slots + 31) / 32 + 3) / 4 * 4;
  p->nwords = (p->sw + 31) / 32;
  p->uw = (h_users + 31) / 32;
  p->words = 32 * (2 * (size_t)p->sw + p->nwords + 6 * (size_t)p->uw);
  int dev = 0, limit = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  p->in_smem = 4 * p->words <= (size_t)limit;
  return (int)rc;
}

}  // namespace

// Bytes of global scratch each lane needs (0 when its state fits in shared
// memory), or -1 when the query fails or the size overflows an int.
extern "C" int dag_event_scratch_bytes(int h_users, int max_slots) {
  Plan p;
  if (plan(h_users, max_slots, &p) != 0) return -1;
  if (p.in_smem) return 0;
  return 4 * p.words > (size_t)0x7fffffff ? -1 : (int)(4 * p.words);
}

// n_tasks int32 and t_avg float32 (lanes, K); n_stages, slots_cap,
// n_active int32 and think_ms float32 (lanes,); think0 float32 (lanes, H);
// st (lanes, E) 32-bit words (int32 indices in replay mode, float32 unit
// draws otherwise) and td float32 (lanes, E); samples float32
// (sample_rows, n_samples) in replay mode, a stage past its rows reading
// the last; outputs resp_sum, resp_cnt float32 (lanes,);
// scratch: dag_event_scratch_bytes a lane, or null when that is 0.
extern "C" int dag_event_launch(
    const int* n_tasks, const float* t_avg, const int* n_stages,
    const int* slots_cap, const int* n_active, const float* think_ms,
    const float* think0, const unsigned* st, const float* td,
    const float* samples, float* resp_sum, float* resp_cnt, void* scratch,
    int lanes, int K, int h_users, int max_slots, int n_events,
    int n_samples, int sample_rows, int warmup_jobs, int replay,
    void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  Plan p;
  int rc = plan(h_users, max_slots, &p);
  if (rc != 0) return rc;
  if (!p.in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = p.in_smem ? 4 * p.words : 0;
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        dag_event_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
  }
  dag_event_kernel<<<lanes, 32, smem, (cudaStream_t)stream>>>(
      n_tasks, t_avg, n_stages, slots_cap, n_active, think_ms, think0, st,
      td, samples, resp_sum, resp_cnt,
      p.in_smem ? nullptr : (unsigned*)scratch, p.words, K, h_users,
      max_slots, p.sw, p.nwords, p.uw, n_events, n_samples, sample_rows,
      warmup_jobs, replay);
  return (int)cudaGetLastError();
}
