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
// tables (row i is read at step i), so the loop itself is RNG-free.
//
// What bounds it on the H100: not bytes (the draw tables are read once,
// 12 bytes per event) and not operations (a few compares per event with
// incremental minima), but the chain of dependent steps inside each lane:
// step i+1 needs the state step i wrote, so a launch takes the latency of
// one step times the number of events, and with one warp on an SM every
// latency in that chain is exposed.  Lanes are independent (one warp each,
// on idle SMs).  The design shortens the step:
//   * the lane's slots_cap slots, and separately its H users, are cut into
//     32 contiguous blocks, one per thread.  Only the owner of a block
//     writes it, so no step needs __syncwarp or a serial phase.  Each
//     thread keeps its block's minima in registers: the earliest slot end
//     (with that slot's user), its free slots, and of its users the
//     earliest think end and the oldest queued stage (one key: reduce
//     stages below map stages, then by arrival, then by user);
//   * a step changes at most one slot and one user, so only their owners'
//     minima move: in O(1) when a key falls, by a rescan of the one block
//     when the minimum leaves;
//   * selections are __reduce_min_sync on 32-bit keys that order as the
//     clocks do.  Blocks are contiguous and each thread keeps its block's
//     first minimum, so the lowest lane holding the warp's minimum holds
//     the first index, as jnp.argmin and ref.py break ties.
//
// Two kernels share that layout:
//   * qn_event_fast, the main path (at most 512 slots, at most 32 users):
//     each thread holds one user in registers and a block of at most 16
//     slots in shared memory.  A queued user's key is unique (class, the
//     rank of its arrival among the distinct clocks so far, the user: the
//     clock only ever grows, so ranks order as arrivals do and tie where
//     they tie), so the queue's redux names the dispatching user.  The
//     earliest slot end and think end are one key (a slot end sorts before
//     an equal think end, as the reference's t_slot <= t_think), and a
//     second redux on (lane, user) over the lanes holding it names the
//     winner's lane and the user it touches.  The lowest lane with a free
//     slot holds the first free slot; each thread tells from the ballot
//     whether that is itself.  Every thread runs the same straight-line
//     step: the owners' updates are selects, and a thread that owns
//     nothing writes to a padding word of its block, so no step diverges
//     (a divergent branch, and the convergence barriers and checks the
//     compiler then puts before each collective, cost more than the
//     step's selections).  When a completion finds no slot free and leaves
//     a task queued, the next step can only be a dispatch into the slot it
//     freed, of the queue's head (the old one, or the user that has just
//     forked its reduces): the completion takes it at once, with no
//     selection of its own;
//   * qn_event_general, any H and slot count: slot and user state in
//     memory (dynamic shared memory, opt-in above 48 KB, or past the
//     card's shared memory a global scratch slice per lane), runtime-length
//     rescans, clock keys with a ballot and __ffs for the lowest lane.
// Both: now, the response sums and the job count are replicated on every
// thread; the draw tables are prefetched 32 events ahead (one per thread)
// and broadcast with __shfl_sync; steps at or past the lane's logical
// budget are no-ops in the reference, so the loop simply ends there; each
// lane scans only its own slots_cap slots (the slots past it are never
// free and never end, and a slot below cap wins every tie with them).
//
// Keys, the draw prefetch, the fast kernel's block tree (tree_min) and
// qn_event_general's slots in memory (Slots): event_loop.cuh, shared with
// csrc/dag_event.cu.
//
// Rounding matches the reference bit for bit: XLA contracts
// now + e*mean and t_slot + e*think into FMAs, written here as __fmaf_rn;
// the response sum uses __fsub_rn / __fadd_rn; everything else is compares
// and selects; the file is built with --fmad=false.
#include "event_loop.cuh"

namespace {

constexpr unsigned kMapBit = 0x80000000u;  // queued maps sort after reduces
constexpr int kRankBits = 26;    // arrival ranks on the fast path
constexpr int kLaneShift = 27;   // (lane, user) of the second redux

// The three draw tables (st_m, st_r, td) of one lane, as 32-bit words
using QnDraws = Draws<3>;

__device__ __forceinline__ void init_draws(QnDraws& d, const float* st_m,
                                           const float* st_r,
                                           const float* td, int lane,
                                           int n_events, int t) {
  const unsigned* const tabs[3] = {reinterpret_cast<const unsigned*>(st_m),
                                   reinterpret_cast<const unsigned*>(st_r),
                                   reinterpret_cast<const unsigned*>(td)};
  d.init(tabs, lane, n_events, t);
}

// ---------------------------------------------------------------------------
// qn_event_fast: at most 512 slots and 32 users
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32, 1) qn_event_fast(
    const int* __restrict__ n_map, const int* __restrict__ n_reduce,
    const int* __restrict__ slots_cap, const int* __restrict__ n_active,
    const float* __restrict__ m_avg, const float* __restrict__ r_avg,
    const float* __restrict__ think_ms, const float* __restrict__ think0,
    const float* __restrict__ st_m, const float* __restrict__ st_r,
    const float* __restrict__ td, float* __restrict__ resp_sum_out,
    float* __restrict__ resp_cnt_out, int H, int S, int n_events,
    int warmup_jobs, int replay) {
  __shared__ __align__(16) unsigned s_key[32 * kFastStride];
  __shared__ int s_user[32 * kFastStride];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned below = (1u << t) - 1u;     // lanes under this one
  const unsigned user_mask = (1u << kLaneShift) - 1u;
  const unsigned k_inf = clock_key(QN_INF);

  const int nm = n_map[lane], nr = n_reduce[lane];
  const int cap = min(max(slots_cap[lane], 0), S);
  const float ma = m_avg[lane], ra = r_avg[lane], tm = think_ms[lane];
  const int steps = max(0, min(n_events, n_active[lane]));

  // this thread's slots [t*bs, t*bs + sn) and their minima
  const int bs = (cap + 31) / 32;
  const int sn = min(max(cap - t * bs, 0), bs);
  const int blk = t * kFastStride;   // the block's offset in s_key, s_user
#pragma unroll
  for (int k = 0; k < kFastSlots; ++k) {
    s_key[blk + k] = k < sn ? k_inf : kNone;
    s_user[blk + k] = -1;
  }
  unsigned free_bits = (1u << sn) - 1u;
  unsigned s_min = sn > 0 ? k_inf : kNone;
  int s_loc = 0, s_usr = -1;

  // this thread's user t (when t < H)
  unsigned q_key = kNone;     // (map bit, arrival rank, t) while queued
  unsigned h_key = t < H ? clock_key(think0[(size_t)lane * H + t]) : kNone;
  int phase = 0, pending = 0, inflight = 0;
  float job_start = 0.0f;

  QnDraws draws;
  init_draws(draws, st_m, st_r, td, lane, n_events, t);
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  unsigned rank = 0;          // distinct clocks so far, less one
  int done_jobs = 0;
  // a job finished by the previous step: its ballot and response, applied
  // once this step's selections are issued
  unsigned last_done = 0;
  float last_resp = 0.0f;

  const uint4* kv = reinterpret_cast<const uint4*>(s_key + blk);
  for (int i = 0; i < steps; ++i) {
    const unsigned adv = advance_key(s_min, h_key);
    const unsigned g_queue = __reduce_min_sync(FULL_MASK, q_key);
    const unsigned g_adv = __reduce_min_sync(FULL_MASK, adv);
    const unsigned b_free = __ballot_sync(FULL_MASK, free_bits != 0);
    unsigned dw[3];
    draws.at(i, t, dw);
    const float stm_i = __uint_as_float(dw[0]), str_i = __uint_as_float(dw[1]),
                td_i = __uint_as_float(dw[2]);
    const uint4 q0 = kv[0], q1 = kv[1], q2 = kv[2], q3 = kv[3];

    const bool counted = last_done != 0 && done_jobs >= warmup_jobs;
    resp_sum = counted ? __fadd_rn(resp_sum, last_resp) : resp_sum;
    resp_cnt = counted ? __fadd_rn(resp_cnt, 1.0f) : resp_cnt;
    done_jobs += last_done != 0;
    last_done = 0;

    if (b_free != 0 && g_queue != kNone) {                 // dispatch
      const int u = (int)(g_queue & 31u);
      const bool is_map = (g_queue & kMapBit) != 0;
      const float end = replay ? __fadd_rn(now, is_map ? stm_i : str_i)
                               : __fmaf_rn(stm_i, is_map ? ma : ra, now);
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
      unsigned kk[kFastSlots] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                                 q1.z, q1.w, q2.x, q2.y, q2.z, q2.w,
                                 q3.x, q3.y, q3.z, q3.w};
      int ii[kFastSlots];
      const int gone = t == w ? s_loc : -1;
#pragma unroll
      for (int k = 0; k < kFastSlots; ++k) {
        kk[k] = k == gone ? k_inf : kk[k];
        ii[k] = k;
      }
      tree_min<kFastSlots>(kk, ii);
      const int at = t == w ? gone : kFastSlots;
      s_key[blk + at] = k_inf;
      s_user[blk + at] = -1;
      free_bits |= t == w ? 1u << gone : 0u;
      s_min = kk[0];
      s_loc = ii[0];
      s_usr = s_user[blk + s_loc];
      // the task's user
      const bool mine_u = t == who;
      inflight -= mine_u;
      const bool stage_done = mine_u && pending == 0 && inflight == 0;
      const bool fork = stage_done && phase == 1;     // map stage done
      const bool job_done = stage_done && phase != 1; // reduce stage done
      phase = fork ? 2 : job_done ? 0 : phase;
      pending = fork ? nr : pending;
      q_key = fork ? (nr > 0 ? (rank << 5) | (unsigned)t : kNone) : q_key;
      h_key = job_done ? clock_key(__fmaf_rn(td_i, tm, clock)) : h_key;
      const float resp = job_done ? __fsub_rn(clock, job_start) : 0.0f;
      last_done = __ballot_sync(FULL_MASK, job_done);
      last_resp = __shfl_sync(FULL_MASK, resp, who);
      // With no slot free before it, the completion leaves one free slot
      // (the one it ended); when anything is queued, the next step is a
      // dispatch into it, taken here (within the block of draws)
      const unsigned head =
          __any_sync(FULL_MASK, fork && nr > 0)
              ? min(g_queue, (rank << 5) | (unsigned)who) : g_queue;
      if (b_free == 0 && head != kNone && i + 1 < steps &&
          ((i + 1) & 31) != 0) {
        i += 1;
        const int u = (int)(head & 31u);
        const bool is_map = (head & kMapBit) != 0;
        const float st = __uint_as_float(__shfl_sync(
            FULL_MASK, is_map ? draws.cur[0] : draws.cur[1], i & 31));
        const float end = replay ? __fadd_rn(now, st)
                                 : __fmaf_rn(st, is_map ? ma : ra, now);
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
      pending = mine_u ? nm : pending;
      job_start = mine_u ? clock : job_start;
      h_key = mine_u ? k_inf : h_key;
      q_key = mine_u ? (nm > 0 ? kMapBit | (rank << 5) | (unsigned)t : kNone)
                     : q_key;
    }
  }
  if (last_done != 0 && done_jobs >= warmup_jobs) {
    resp_sum = __fadd_rn(resp_sum, last_resp);
    resp_cnt = __fadd_rn(resp_cnt, 1.0f);
  }
  if (t == 0) {
    resp_sum_out[lane] = resp_sum;
    resp_cnt_out[lane] = resp_cnt;
  }
}

// ---------------------------------------------------------------------------
// qn_event_general: any H, any slot count, state in memory
// ---------------------------------------------------------------------------

// This thread's users, global indices [base, base + n), six arrays at
// stride uw.  A user's queue key is its stage arrival while it has tasks
// pending (kMapBit set in the map stage), kNone otherwise; its think key
// is the think end.  Arrival and think end are read through their keys
// only.
struct Users {
  unsigned *pkey, *tkey;
  int *phase, *pending, *inflight;
  float* job_start;
  int base, n, bu;
  unsigned p_min, t_min;
  int p_loc, t_loc;

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
    p_min = kNone;
    p_loc = 0;
    rescan(tkey, t_min, t_loc);
  }

  __device__ __forceinline__ void rescan(const unsigned* keys, unsigned& m,
                                         int& loc) {
    m = kNone;
    loc = 0;
    for (int l = 0; l < n; ++l) {
      const unsigned x = keys[l];
      if (x < m) {
        m = x;
        loc = l;
      }
    }
  }

  // the oldest queued stage's user sends one task to a slot
  __device__ __forceinline__ void dispatch() {
    const int l = p_loc;
    const int p = pending[l] - 1;
    pending[l] = p;
    inflight[l] += 1;
    if (p == 0) {
      pkey[l] = kNone;
      rescan(pkey, p_min, p_loc);
    }
  }

  // a task of global user u completed at t_slot; returns true when its job
  // ended (then *resp is its response time)
  __device__ __forceinline__ bool complete(int u, float t_slot, float td,
                                           float tm, int nr, float* resp) {
    const int l = u - base;
    const int infl = inflight[l] - 1;
    inflight[l] = infl;
    if (pending[l] != 0 || infl != 0) return false;
    if (phase[l] == 1) {                  // map stage done: fork reduces
      const unsigned k = nr > 0 ? clock_key(t_slot) : kNone;
      phase[l] = 2;
      pending[l] = nr;
      pkey[l] = k;
      take_min(p_min, p_loc, k, l);
      return false;
    }
    // reduce stage done: the job ends and a think starts
    const unsigned k = clock_key(__fmaf_rn(td, tm, t_slot));
    phase[l] = 0;
    tkey[l] = k;
    take_min(t_min, t_loc, k, l);
    *resp = __fsub_rn(t_slot, job_start[l]);
    return true;
  }

  // the earliest think ends at t_think: the user submits a job of nm maps
  __device__ __forceinline__ void think(float t_think, int nm) {
    const unsigned k = nm > 0 ? (kMapBit | clock_key(t_think)) : kNone;
    const int l = t_loc;
    phase[l] = 1;
    pending[l] = nm;
    job_start[l] = t_think;
    tkey[l] = clock_key(QN_INF);
    rescan(tkey, t_min, t_loc);
    pkey[l] = k;
    take_min(p_min, p_loc, k, l);
  }
};

__global__ void __launch_bounds__(32) qn_event_general(
    const int* __restrict__ n_map, const int* __restrict__ n_reduce,
    const int* __restrict__ slots_cap, const int* __restrict__ n_active,
    const float* __restrict__ m_avg, const float* __restrict__ r_avg,
    const float* __restrict__ think_ms, const float* __restrict__ think0,
    const float* __restrict__ st_m, const float* __restrict__ st_r,
    const float* __restrict__ td, float* __restrict__ resp_sum_out,
    float* __restrict__ resp_cnt_out, unsigned* scratch,
    size_t scratch_words, int H, int S, int sw, int nwords, int uw,
    int n_events, int warmup_jobs, int replay) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  unsigned* region =
      scratch == nullptr ? smem : scratch + (size_t)lane * scratch_words;
  const unsigned k_inf = clock_key(QN_INF);

  const int nm = n_map[lane], nr = n_reduce[lane];
  const int cap = min(max(slots_cap[lane], 0), S);
  const float ma = m_avg[lane], ra = r_avg[lane], tm = think_ms[lane];
  const int steps = max(0, min(n_events, n_active[lane]));

  Slots slots;
  slots.init(region, t, sw, nwords, cap);
  Users users;
  users.init(region + 64 * (size_t)sw + 32 * (size_t)nwords, t, uw, H,
             think0 + (size_t)lane * H);
  QnDraws draws;
  init_draws(draws, st_m, st_r, td, lane, n_events, t);
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  int done_jobs = 0;

  for (int i = 0; i < steps; ++i) {
    unsigned dw[3];
    draws.at(i, t, dw);
    const float stm_i = __uint_as_float(dw[0]), str_i = __uint_as_float(dw[1]),
                td_i = __uint_as_float(dw[2]);
    const unsigned adv = advance_key(slots.min_key, users.t_min);
    const unsigned g_free = __reduce_min_sync(FULL_MASK, slots.free_key());
    const unsigned g_queue = __reduce_min_sync(FULL_MASK, users.p_min);
    const unsigned g_adv = __reduce_min_sync(FULL_MASK, adv);

    if (g_free != kNone && g_queue != kNone) {              // dispatch
      const bool is_map = (g_queue & kMapBit) != 0;
      const float end = replay ? __fadd_rn(now, is_map ? stm_i : str_i)
                               : __fmaf_rn(stm_i, is_map ? ma : ra, now);
      const int wu =
          __ffs(__ballot_sync(FULL_MASK, users.p_min == g_queue)) - 1;
      const int u = __shfl_sync(FULL_MASK, users.base + users.p_loc, wu);
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
      if (t == wc) job_done = users.complete(cu, clock, td_i, tm, nr, &resp);
      if (__ballot_sync(FULL_MASK, job_done)) {
        resp = __shfl_sync(FULL_MASK, resp, wc);
        if (done_jobs >= warmup_jobs) {
          resp_sum = __fadd_rn(resp_sum, resp);
          resp_cnt = __fadd_rn(resp_cnt, 1.0f);
        }
        done_jobs += 1;
      }
    } else if (t == w) {                                    // think end
      users.think(clock, nm);
    }
    now = clock;
  }
  if (t == 0) {
    resp_sum_out[lane] = resp_sum;
    resp_cnt_out[lane] = resp_cnt;
  }
}

// Which kernel (qn_event_general when asked for, or when the lane outgrows
// qn_event_fast), and where qn_event_general keeps a lane's state, in 32-bit
// words: slot keys and users (32 blocks of sw), free-mask words (32 x
// nwords) and six per-user arrays (32 blocks of uw).  It lives in dynamic
// shared memory when it fits the card's opt-in limit, else in a global
// scratch slice per lane.
struct Plan {
  bool fast;
  int sw, nwords, uw;
  size_t words;
  bool in_smem;
};

int plan(int h_users, int max_slots, int n_events, bool general, Plan* p) {
  p->fast = !general && max_slots <= 32 * kFastSlots && h_users <= 32 &&
            n_events < (1 << kRankBits);
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

// Bytes of global scratch each lane of qn_event_general needs (0 when its
// state fits in shared memory, as it always does where qn_event_fast can
// run), or -1 when the query fails or the size overflows an int.
extern "C" int qn_event_scratch_bytes(int h_users, int max_slots,
                                      int n_events) {
  Plan p;
  if (plan(h_users, max_slots, n_events, true, &p) != 0) return -1;
  if (p.in_smem) return 0;
  return 4 * p.words > (size_t)0x7fffffff ? -1 : (int)(4 * p.words);
}

extern "C" int qn_event_launch(
    const int* n_map, const int* n_reduce, const int* slots_cap,
    const int* n_active, const float* m_avg, const float* r_avg,
    const float* think_ms, const float* think0, const float* st_m,
    const float* st_r, const float* td, float* resp_sum, float* resp_cnt,
    void* scratch, int lanes, int h_users, int max_slots, int n_events,
    int warmup_jobs, int replay, int general, int* fast, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  Plan p;
  int rc = plan(h_users, max_slots, n_events, general != 0, &p);
  if (rc != 0) return rc;
  *fast = p.fast;  // which kernel the wrapper counts
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.fast) {
    qn_event_fast<<<lanes, 32, 0, s>>>(
        n_map, n_reduce, slots_cap, n_active, m_avg, r_avg, think_ms, think0,
        st_m, st_r, td, resp_sum, resp_cnt, h_users, max_slots, n_events,
        warmup_jobs, replay);
    return (int)cudaGetLastError();
  }
  if (!p.in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = p.in_smem ? 4 * p.words : 0;
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        qn_event_general, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
  }
  qn_event_general<<<lanes, 32, smem, s>>>(
      n_map, n_reduce, slots_cap, n_active, m_avg, r_avg, think_ms, think0,
      st_m, st_r, td, resp_sum, resp_cnt,
      p.in_smem ? nullptr : (unsigned*)scratch, p.words, h_users, max_slots,
      p.sw, p.nwords, p.uw, n_events, warmup_jobs, replay);
  return (int)cudaGetLastError();
}
