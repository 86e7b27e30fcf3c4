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
// times the number of events.  Two kernels, on qn_event's two layouts:
//   * dag_event_fast, for lanes of at most 32 users and 512 slots (every
//     DAG drive): each thread holds one user in registers (phase, pending,
//     inflight, job start, think key, queue key) and a block of at most 16
//     slots in static shared memory (an instance each for blocks of 4, 8
//     and 16, as the batch's slots need, and for each mode), with the
//     block's minima in registers (earliest end, its user, free bits).
//     The queue order is one 32-bit key, ((31 - stage depth) << 27) |
//     (arrival rank << 5) | user: the deepest stage first, then the
//     earliest arrival (the rank of its clock among the distinct clocks so
//     far: the clock only grows, so ranks order as arrivals do and tie
//     where they tie), then the first user, as jnp.argmin breaks ties; one
//     __reduce_min_sync names the dispatching user and its stage.  The
//     stage arrays live in registers too (thread k holds stage k), and
//     each user's thread keeps its current stage's mean (or, in replay
//     mode, its sample row) and its next stage's mean and task count,
//     refreshed by a __shfl_sync off the chain when the stage starts, so
//     no step reads t_avg or n_tasks from memory: a dispatch takes the
//     mean with one __shfl_sync from its user's thread (in replay mode
//     each thread gathers its own user's sample for the step before the
//     selection, and the dispatch shuffles that).  With one warp an SM
//     the step's instructions run one after another, so the step
//     carries none it does not need: the steps run in blocks of 32 with
//     the draw tables switched between blocks (not predicated into every
//     step), the mode is a template parameter, and the step is
//     straight-line, as qn_event_fast's: the owners' updates are selects
//     (a forked stage's key too: formed before the select, so that it is
//     no branch with its convergence barrier), a thread that owns nothing
//     writes a padding word, and a completion that frees the only slot
//     with a task queued takes the dispatch that must follow it, into that
//     slot, of the queue's head (the old head, or the user that has just
//     forked its next stage).  The key's fields bound the route: at most
//     31 stages (K <= 31), ranks below 2^22 (E < 2^22 events);
//   * dag_event_kernel, any H, slot count and K, on qn_event_general's
//     layout: the lane's slots_cap slots (event_loop.cuh Slots) and its H
//     users are cut into 32 contiguous blocks, one a thread, in dynamic
//     shared memory (opt-in above 48 KB) or past the card's shared memory
//     in a global scratch slice per lane; only the owner of a block writes
//     it, and it keeps its block's minima in registers (the earliest slot
//     end with its user, the first free slot, the earliest think end, the
//     first queued user), moved in O(1) when a key falls and by a rescan
//     of the one block when the minimum leaves.  Its queue order is a
//     64-bit key, (0x7fffffff - stage) above the arrival's clock key,
//     taken in two 32-bit reductions (the stage word, then the arrival
//     among the lanes at that stage); a ballot with __ffs names the lowest
//     lane holding it, whose block's first minimum is the first user.
// Both: the draw tables are prefetched 32 events ahead (one per thread)
// and broadcast with __shfl_sync; steps at or past the lane's logical
// budget are no-ops in the reference, so the loop ends there.  Stage
// arrays are padded to a bucket of K; each lane clips its stage indices to
// its own n_stages, as the reference does.  The route is chosen by the
// caller (kernels/dag_event/ops.py route()); the launcher refuses a fast
// launch past the fast kernel's limits.
//
// Rounding matches the reference bit for bit: XLA contracts now + e*mean
// (exponential mode) and t_slot + e*think into FMAs, written here as
// __fmaf_rn; replay mode adds a gathered sample (__fadd_rn); the response
// sum uses __fsub_rn / __fadd_rn; everything else is compares and
// selects; the file is built with --fmad=false.
#include "event_loop.cuh"

namespace {

constexpr unsigned long long kNoQueue = ~0ull;

// The service table (int32 sample indices in replay mode, float32 unit
// draws otherwise) and the think table of one lane, as 32-bit words
using DagDraws = Draws<2>;

__device__ __forceinline__ void init_draws(DagDraws& d, const unsigned* st,
                                           const float* td, int lane,
                                           int n_events, int t) {
  const unsigned* const tabs[2] = {st,
                                   reinterpret_cast<const unsigned*>(td)};
  d.init(tabs, lane, n_events, t);
}

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
  init_draws(draws, st, td, lane, n_events, t);
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  int done_jobs = 0;

  for (int i = 0; i < steps; ++i) {
    unsigned dw[2];
    draws.at(i, t, dw);
    const unsigned st_i = dw[0];
    const float td_i = __uint_as_float(dw[1]);
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

// ---------------------------------------------------------------------------
// dag_event_fast: at most 32 users, 512 slots, 31 stages and 2^22 events
// ---------------------------------------------------------------------------

constexpr int kFastUsers = 32;
constexpr int kDepthShift = 27;   // the queue key's stage field, 5 bits
constexpr int kMaxDepth = 31;     // the deepest stage it holds
constexpr int kRankBits = 22;     // its arrival-rank field
constexpr int kLaneShift = 27;    // (lane, user) of the second redux

// user t's queue key at stage `depth`, queued at the clock of rank `rank`
__device__ __forceinline__ unsigned queue_key(int depth, unsigned rank,
                                              int t) {
  return ((unsigned)(kMaxDepth - depth) << kDepthShift) | (rank << 5) |
         (unsigned)t;
}

// W: the slots a thread's block holds (4, 8 or 16: the batch's slots over
// 32, rounded up), so that a completion's tree and loads span no more of
// the block than the batch can fill; REPLAY: the batch replays sample
// lists (else its draws are unit exponentials)
template <int W, bool REPLAY>
__global__ void __launch_bounds__(32, 1) dag_event_fast(
    const int* __restrict__ n_tasks, const float* __restrict__ t_avg,
    const int* __restrict__ n_stages, const int* __restrict__ slots_cap,
    const int* __restrict__ n_active, const float* __restrict__ think_ms,
    const float* __restrict__ think0, const unsigned* __restrict__ st,
    const float* __restrict__ td, const float* __restrict__ samples,
    float* __restrict__ resp_sum_out, float* __restrict__ resp_cnt_out,
    int K, int H, int S, int n_events, int n_samples, int sample_rows,
    int warmup_jobs) {
  __shared__ __align__(16) unsigned s_key[32 * kFastStride];
  __shared__ int s_user[32 * kFastStride];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned below = (1u << t) - 1u;     // lanes under this one
  const unsigned user_mask = (1u << kLaneShift) - 1u;
  const unsigned k_inf = clock_key(QN_INF);

  const int ns = n_stages[lane];
  const int cap = min(max(slots_cap[lane], 0), S);
  const float tm = think_ms[lane];
  const int steps = max(0, min(n_events, n_active[lane]));

  // the stage arrays in registers: thread k holds stage k's task count and
  // mean (in replay mode the offset of its sample row, the last row for a
  // stage past them, as the reference's gather clamps)
  const int kt = min(t, K - 1);
  const int k_tasks = n_tasks[(size_t)lane * K + kt];
  const unsigned k_val =
      REPLAY ? (unsigned)min(kt, sample_rows - 1) * (unsigned)n_samples
             : __float_as_uint(t_avg[(size_t)lane * K + kt]);
  // the arrays' index of stage ph: clip(ph - 1, 0, n_stages - 1), within K
  const auto stage_at = [&](int ph) {
    return min(max(min(ph - 1, ns - 1), 0), K - 1);
  };
  // a job's first stage (its task count is n_tasks[0]) and its second
  const int nt1 = __shfl_sync(FULL_MASK, k_tasks, 0);
  const unsigned v1 = __shfl_sync(FULL_MASK, k_val, 0);
  const int nt2 = __shfl_sync(FULL_MASK, k_tasks, stage_at(2));
  const unsigned v2 = __shfl_sync(FULL_MASK, k_val, stage_at(2));

  // this thread's slots [t*bs, t*bs + sn) and their minima
  const int bs = (cap + 31) / 32;
  const int sn = min(max(cap - t * bs, 0), bs);
  const int blk = t * kFastStride;   // the block's offset in s_key, s_user
#pragma unroll
  for (int k = 0; k < W; ++k) {
    s_key[blk + k] = k < sn ? k_inf : kNone;
    s_user[blk + k] = -1;
  }
  unsigned free_bits = (1u << sn) - 1u;
  unsigned s_min = sn > 0 ? k_inf : kNone;
  int s_loc = 0, s_usr = -1;

  // this thread's user t (when t < H), with its stage's mean (or sample
  // row) and the next stage's mean and task count
  unsigned q_key = kNone;     // queue_key(phase, arrival rank, t) if queued
  unsigned h_key = t < H ? clock_key(think0[(size_t)lane * H + t]) : kNone;
  int phase = 0, pending = 0, inflight = 0;
  float job_start = 0.0f;
  unsigned cur_val = v1, nxt_val = v2;
  int nxt_tasks = nt2;

  DagDraws draws;
  init_draws(draws, st, td, lane, n_events, t);
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  unsigned rank = 0;          // distinct clocks so far, less one
  int done_jobs = 0;
  // the response of a job the previous step finished (-1: none), counted
  // once this step's selections are under way
  float last_resp = -1.0f;

  const uint4* kv = reinterpret_cast<const uint4*>(s_key + blk);
  // steps in blocks of 32, one block of draws each (switched here, not in
  // the step)
  for (int b = 0; b < steps; b += 32) {
    draws.block(b, t);
    const int b_end = min(b + 32, steps);
    for (int i = b; i < b_end; ++i) {
      const unsigned adv = advance_key(s_min, h_key);
      const unsigned g_queue = __reduce_min_sync(FULL_MASK, q_key);
      const unsigned g_adv = __reduce_min_sync(FULL_MASK, adv);
      const unsigned b_free = __ballot_sync(FULL_MASK, free_bits != 0);
      const unsigned st_i = draws.word(0, i);
      // what a dispatch of this thread's user takes: its stage's mean, or in
      // replay mode its stage's sample for this step
      const unsigned mine =
          REPLAY ? __float_as_uint(samples[cur_val + st_i]) : cur_val;
      uint4 q[W / 4];
#pragma unroll
      for (int j = 0; j < W / 4; ++j) q[j] = kv[j];

      const bool counted = last_resp >= 0.0f && done_jobs >= warmup_jobs;
      resp_sum = counted ? __fadd_rn(resp_sum, last_resp) : resp_sum;
      resp_cnt = counted ? __fadd_rn(resp_cnt, 1.0f) : resp_cnt;
      done_jobs += last_resp >= 0.0f;
      last_resp = -1.0f;

      if (b_free != 0 && g_queue != kNone) {                 // dispatch
        const int u = (int)(g_queue & 31u);
        const float v = __uint_as_float(__shfl_sync(FULL_MASK, mine, u));
        const float end = REPLAY ? __fadd_rn(now, v)
                                 : __fmaf_rn(__uint_as_float(st_i), v, now);
        // owners' updates as selects; a thread that owns nothing writes
        // to its block's padding word
        const bool mine_u = t == u;
        pending -= mine_u;
        inflight += mine_u;
        q_key = mine_u && pending == 0 ? kNone : q_key;
        const bool mine_s = free_bits != 0 && (b_free & below) == 0;
        const int l = __ffs(free_bits) - 1;                  // first free
        const unsigned k = clock_key(end);
        const int at = mine_s ? l : kFastSlots;
        s_key[blk + at] = k;
        s_user[blk + at] = u;
        free_bits = mine_s ? free_bits & (free_bits - 1u) : free_bits;
        const bool lower = mine_s && (k < s_min || (k == s_min && l < s_loc));
        s_min = lower ? k : s_min;
        s_loc = lower ? l : s_loc;
        s_usr = lower ? u : s_usr;
        continue;
      }
      const unsigned ka = g_adv >> 1;
      if (ka >= k_inf) continue;                             // nothing left
      const float clock = key_clock(ka);
      const bool is_think = (g_adv & 1u) != 0;
      // the lowest lane holding the earliest end, and its user
      const unsigned g_who = __reduce_min_sync(
          FULL_MASK, adv == g_adv ? ((unsigned)t << kLaneShift) |
                                        ((is_think ? t : s_usr) & user_mask)
                                  : kNone);
      const int w = (int)(g_who >> kLaneShift);
      const int who = (int)(g_who & user_mask);
      rank += clock != now;
      now = clock;
      if (!is_think) {                                       // completion
        // every thread reruns its block's tree, the owner without the slot
        // that completes; the others find their minimum unchanged
        unsigned kk[W];
        int ii[W];
        const int gone = t == w ? s_loc : -1;
#pragma unroll
        for (int j = 0; j < W / 4; ++j) {
          kk[4 * j] = q[j].x;
          kk[4 * j + 1] = q[j].y;
          kk[4 * j + 2] = q[j].z;
          kk[4 * j + 3] = q[j].w;
        }
#pragma unroll
        for (int k = 0; k < W; ++k) {
          kk[k] = k == gone ? k_inf : kk[k];
          ii[k] = k;
        }
        tree_min<W>(kk, ii);
        const int at = t == w ? gone : kFastSlots;
        s_key[blk + at] = k_inf;
        s_user[blk + at] = -1;
        free_bits |= t == w ? 1u << gone : 0u;
        s_min = kk[0];
        s_loc = ii[0];
        s_usr = s_user[blk + s_loc];
        // the task's user: its stage done forks the next one, or after the
        // last stage the job ends and a think starts
        const float td_i = __uint_as_float(draws.word(1, i));
        const bool mine_u = t == who;
        inflight -= mine_u;
        const bool stage_done = mine_u && pending == 0 && inflight == 0;
        const bool fork = stage_done && phase < ns;
        const bool job_done = stage_done && phase >= ns;
        // the key a fork queues the next stage with, formed whatever the
        // branch (a select, not a branch of its own)
        const unsigned fk =
            nxt_tasks > 0 ? queue_key(phase + 1, rank, t) : kNone;
        phase = fork ? phase + 1 : job_done ? 0 : phase;
        pending = fork ? nxt_tasks : pending;
        cur_val = fork ? nxt_val : cur_val;
        q_key = fork ? fk : q_key;
        h_key = job_done ? clock_key(__fmaf_rn(td_i, tm, clock)) : h_key;
        last_resp = __shfl_sync(
            FULL_MASK, job_done ? __fsub_rn(clock, job_start) : -1.0f, who);
        const unsigned forked =
            __shfl_sync(FULL_MASK, fork ? q_key : kNone, who);
        // the stage after the user's current one, for its next fork: read
        // here, off the chain
        const int nx = stage_at(phase + 1);
        nxt_tasks = __shfl_sync(FULL_MASK, k_tasks, nx);
        nxt_val = __shfl_sync(FULL_MASK, k_val, nx);
        // With no slot free before it, the completion leaves one free slot
        // (the one it ended); when anything is queued, the next step is a
        // dispatch into it, of the queue's head, taken here (within the
        // block of draws)
        const unsigned head = min(g_queue, forked);
        if (b_free == 0 && head != kNone && i + 1 < b_end) {
          i += 1;
          const int u = (int)(head & 31u);
          const unsigned sv = draws.word(0, i);
          const unsigned m =
              REPLAY ? __float_as_uint(samples[cur_val + sv]) : cur_val;
          const float v = __uint_as_float(__shfl_sync(FULL_MASK, m, u));
          const float end = REPLAY ? __fadd_rn(now, v)
                                   : __fmaf_rn(__uint_as_float(sv), v, now);
          const bool mine_d = t == u;
          pending -= mine_d;
          inflight += mine_d;
          q_key = mine_d && pending == 0 ? kNone : q_key;
          const unsigned k = clock_key(end);
          const bool mine_s = t == w;
          s_key[blk + at] = mine_s ? k : k_inf;
          s_user[blk + at] = mine_s ? u : -1;
          free_bits = mine_s ? free_bits & ~(1u << gone) : free_bits;
          const bool lower =
              mine_s && (k < s_min || (k == s_min && gone < s_loc));
          s_min = lower ? k : s_min;
          s_loc = lower ? gone : s_loc;
          s_usr = lower ? u : s_usr;
        }
      } else {                                               // think end
        const bool mine_u = t == w;
        phase = mine_u ? 1 : phase;
        pending = mine_u ? nt1 : pending;
        job_start = mine_u ? clock : job_start;
        h_key = mine_u ? k_inf : h_key;
        q_key = mine_u ? (nt1 > 0 ? queue_key(1, rank, t) : kNone) : q_key;
        cur_val = mine_u ? v1 : cur_val;
        nxt_val = mine_u ? v2 : nxt_val;
        nxt_tasks = mine_u ? nt2 : nxt_tasks;
      }
    }
  }
  if (last_resp >= 0.0f && done_jobs >= warmup_jobs) {
    resp_sum = __fadd_rn(resp_sum, last_resp);
    resp_cnt = __fadd_rn(resp_cnt, 1.0f);
  }
  if (t == 0) {
    resp_sum_out[lane] = resp_sum;
    resp_cnt_out[lane] = resp_cnt;
  }
}

// The fast step's collectives alone, for chip_smoke.py's floor of a step:
// one warp runs n dependent rounds of one of them, each round's input the
// last round's output, so that a long launch against a short one gives a
// round's latency.  No path launches it.  OP 0: a 32-bit
// __reduce_min_sync (and the add that varies its input); 1: __ballot_sync
// and __ffs (and the compare that feeds the ballot); 2: __shfl_sync (and
// the add that feeds it).
template <int OP>
__global__ void __launch_bounds__(32, 1) dag_collective_chain(unsigned* out,
                                                              int n) {
  const unsigned t = threadIdx.x;
  unsigned x = t;
  for (int i = 0; i < n; ++i) {
    if constexpr (OP == 0)
      x = __reduce_min_sync(FULL_MASK, x + t);
    else if constexpr (OP == 1)
      x = (unsigned)__ffs(__ballot_sync(FULL_MASK, t >= x)) & 31u;
    else
      x = __shfl_sync(FULL_MASK, x + 1u, x & 31u);
  }
  out[t] = x;
}

// ---------------------------------------------------------------------------
// dag_event_kernel's layout
// ---------------------------------------------------------------------------

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

// Whether a lane batch fits dag_event_fast: the users in one warp's
// threads, the slots in 16 a thread, the stages in the queue key's stage
// field and the events in its rank field.  kernels/dag_event/ops.py
// route() decides with the same limits.
bool fits_fast(int h_users, int max_slots, int K, int n_events) {
  return h_users <= kFastUsers && max_slots <= 32 * kFastSlots &&
         K <= kMaxDepth && n_events < (1 << kRankBits);
}

using FastKernel = void (*)(const int*, const float*, const int*,
                            const int*, const int*, const float*,
                            const float*, const unsigned*, const float*,
                            const float*, float*, float*, int, int, int, int,
                            int, int, int);

// the instance of dag_event_fast whose block holds a batch's slots
template <bool REPLAY>
FastKernel fast_kernel(int max_slots) {
  const int bs = (max_slots + 31) / 32;
  return bs <= 4   ? dag_event_fast<4, REPLAY>
         : bs <= 8 ? dag_event_fast<8, REPLAY>
                   : dag_event_fast<kFastSlots, REPLAY>;
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
// the last; outputs resp_sum, resp_cnt float32 (lanes,); scratch:
// dag_event_scratch_bytes a lane for dag_event_kernel, or null when that is
// 0.  fast = 1 launches dag_event_fast, and is refused
// (cudaErrorInvalidValue) for a batch past its limits; 0 launches
// dag_event_kernel.
extern "C" int dag_event_launch(
    const int* n_tasks, const float* t_avg, const int* n_stages,
    const int* slots_cap, const int* n_active, const float* think_ms,
    const float* think0, const unsigned* st, const float* td,
    const float* samples, float* resp_sum, float* resp_cnt, void* scratch,
    int lanes, int K, int h_users, int max_slots, int n_events,
    int n_samples, int sample_rows, int warmup_jobs, int replay, int fast,
    void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (fast) {
    if (!fits_fast(h_users, max_slots, K, n_events))
      return (int)cudaErrorInvalidValue;
    const FastKernel kernel = replay ? fast_kernel<true>(max_slots)
                                     : fast_kernel<false>(max_slots);
    kernel<<<lanes, 32, 0, s>>>(
        n_tasks, t_avg, n_stages, slots_cap, n_active, think_ms, think0, st,
        td, samples, resp_sum, resp_cnt, K, h_users, max_slots, n_events,
        n_samples, sample_rows, warmup_jobs);
    return (int)cudaGetLastError();
  }
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
  dag_event_kernel<<<lanes, 32, smem, s>>>(
      n_tasks, t_avg, n_stages, slots_cap, n_active, think_ms, think0, st,
      td, samples, resp_sum, resp_cnt,
      p.in_smem ? nullptr : (unsigned*)scratch, p.words, K, h_users,
      max_slots, p.sw, p.nwords, p.uw, n_events, n_samples, sample_rows,
      warmup_jobs, replay);
  return (int)cudaGetLastError();
}

// The draw tables' entry point (csrc/dag_streams.cu), which dag_sim_launch
// runs first.
extern "C" int dag_streams_launch(const long long* seed, const int* n_active,
                                  const float* think_ms, unsigned* tables,
                                  int B, int H, int E, int n_samples,
                                  int replay, void* stream);

// One fused simulation on one stream: the draw tables (dag_streams_launch,
// into `tables`, B * (2E + H) words laid out [st | td | think0]), then the
// event loop on them (dag_event_launch), writing resp_sum then resp_cnt
// into `resp` (2 * lanes floats).  The other arguments are
// dag_event_launch's; depth is the deepest lane's n_stages, read on the
// host.  A fast launch past dag_event_fast's limits, or over a lane deeper
// than the stage arrays (K, at most its queue key's stage field), is
// refused (cudaErrorInvalidValue) before anything runs.
extern "C" int dag_sim_launch(
    const long long* seed, const int* n_tasks, const float* t_avg,
    const int* n_stages, const int* slots_cap, const int* n_active,
    const float* think_ms, const float* samples, unsigned* tables,
    float* resp, void* scratch, int lanes, int K, int h_users, int max_slots,
    int n_events, int n_samples, int sample_rows, int warmup_jobs, int replay,
    int fast, int depth, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  if (fast && (!fits_fast(h_users, max_slots, K, n_events) || depth > K))
    return (int)cudaErrorInvalidValue;
  const int rc = dag_streams_launch(seed, n_active, think_ms, tables, lanes,
                                    h_users, n_events, n_samples, replay,
                                    stream);
  if (rc != 0) return rc;
  const size_t n = (size_t)lanes * n_events;
  return dag_event_launch(
      n_tasks, t_avg, n_stages, slots_cap, n_active, think_ms,
      reinterpret_cast<const float*>(tables + 2 * n), tables,
      reinterpret_cast<const float*>(tables + n), samples, resp,
      resp + lanes, scratch, lanes, K, h_users, max_slots, n_events,
      n_samples, sample_rows, warmup_jobs, replay, fast, stream);
}

// n dependent rounds of collective op (dag_collective_chain) on one warp,
// writing 32 words to out; refused for an op that is not 0, 1 or 2.
extern "C" int dag_collective_chain_launch(void* out, int n, int op,
                                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned* o = (unsigned*)out;
  if (op == 0)
    dag_collective_chain<0><<<1, 32, 0, s>>>(o, n);
  else if (op == 1)
    dag_collective_chain<1><<<1, 32, 0, s>>>(o, n);
  else if (op == 2)
    dag_collective_chain<2><<<1, 32, 0, s>>>(o, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
