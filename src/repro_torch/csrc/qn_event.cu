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
// Four kernels share that layout:
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
//     selection of its own.  The steps run in blocks of 32, the draw
//     tables switched between blocks (not predicated into every step), and
//     the mode is a template parameter;
//   * qn_event_wide, the same step for lanes of at most 32 users past 512
//     slots, up to 16384 (cost_deadline's point-wise probes): a thread's
//     block of up to 512 slots is cut into groups of 16 (kFastSlots) in
//     dynamic shared memory, each group's first minimum (key, slot) and
//     free mask kept beside it, and the thread keeps in registers its
//     block's first minimum and a mask of its groups with a free slot.  A
//     dispatch only lowers keys (O(1)); the first free slot is two __ffs
//     (the group mask, then that group's free mask); a completion
//     refreshes the one group (tree_min over its 16 keys), stores its new
//     minimum and refreshes the block over its group minima (tree_min over
//     at most 32), so no step runs a loop of runtime length.  An instance per block size (4, 8, 16
//     or 32 groups a thread, as the batch's slots need) and mode;
//   * qn_event_many, the same step in a copy of its own for lanes of 33 to
//     2048 users (the capacity planner's serving classes: 64 to 2048
//     sessions) with the slots of FlatBlock or GroupBlock: thread t owns
//     a contiguous block of at most 64 users, in groups of 16 in dynamic
//     shared memory (a queue key, a think key, pending, remaining, phase
//     and job start each).
//     Each group's first minimum of both keys sits beside it (one group a
//     thread up to 512 users: its minima are the block's), and the thread
//     keeps its block's minima in registers.  A queue key is unique as
//     qn_event_fast's (class, rank, user: 11 bits of user leave 20 of
//     rank), so the queue's redux names the user.  A step changes at most
//     one user's key up (a think ends, a dispatch empties a user) and one
//     down (a fork, a job end): a raise refreshes the user's group
//     (min or tree_min over its 16 keys, read at the step's top) and the
//     block over at most 4 group minima; a fall is O(1).  No loop has a
//     runtime length;
//   * qn_event_general, any H and slot count: slot and user state in
//     memory (dynamic shared memory, opt-in above 48 KB, or past the
//     card's shared memory a global scratch slice per lane), runtime-length
//     rescans, clock keys with a ballot and __ffs for the lowest lane.
// All: now, the response sums and the job count are replicated on every
// thread; the draw tables are prefetched 32 events ahead (one per thread)
// and broadcast with __shfl_sync; steps at or past the lane's logical
// budget are no-ops in the reference, so the loop simply ends there; each
// lane scans only its own slots_cap slots (the slots past it are never
// free and never end, and a slot below cap wins every tie with them).
// The route is plan()'s, the one place it is decided.
//
// Keys, the draw prefetch, the block tree (tree_min) and qn_event_general's
// slots in memory (Slots): event_loop.cuh, shared with csrc/dag_event.cu.
//
// Rounding matches the reference bit for bit: XLA contracts
// now + e*mean and t_slot + e*think into FMAs, written here as __fmaf_rn;
// the response sum uses __fsub_rn / __fadd_rn; everything else is compares
// and selects; the file is built with --fmad=false.
#include "event_loop.cuh"

namespace {

constexpr unsigned kMapBit = 0x80000000u;  // queued maps sort after reduces
constexpr int kFastUsers = 32;   // users of the fast and wide routes
constexpr int kRankBits = 26;    // their arrival ranks
constexpr int kLaneShift = 27;   // (lane, user) of the second redux
constexpr int kWideGroups = 32;  // groups of kFastSlots a wide thread holds
constexpr int kManyUsers = 2048;     // users of qn_event_many
constexpr int kManyUserBits = 11;    // their queue keys' user field
constexpr int kManyRankBits = 20;    // and arrival ranks
constexpr int kManyGroups = 4;       // groups of 16 users a thread past 512

// The route qn_event_launch reports; kernels/qn_event/ops.py ROUTES names
// them in this order
enum Route { kGeneral = 0, kFast = 1, kWide = 2, kMany = 3 };

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

// (k, l) before (m, loc): the smaller key, the lower slot on ties.  Bitwise,
// not short-circuit: with a per-thread operand a short-circuit compare can
// compile to a divergent branch, and its convergence barrier costs the
// step more than the compares
__device__ __forceinline__ bool before(unsigned k, int l, unsigned m,
                                       int loc) {
  return (k < m) | ((k == m) & (l < loc));
}

// (key, slot, user) of a block's first minimum lowered by a dispatch of
// user u into slot l with key k, where mine
__device__ __forceinline__ void lower_min(unsigned& m, int& loc, int& usr,
                                          bool mine, unsigned k, int l,
                                          int u) {
  const bool lo = mine & before(k, l, m, loc);
  m = lo ? k : m;
  loc = lo ? l : loc;
  usr = lo ? u : usr;
}

// ---------------------------------------------------------------------------
// The slot blocks of the fast and wide routes.  Thread t owns the lane's
// slots [t*bs, t*bs + sn), bs = ceil(cap / 32); a slot's key is its end's
// clock key (QN_INF free, kNone past the block), its user the task's.
// Both keep (lo_key, loc, usr), the block's first earliest end, in registers
// and take the same calls: prefetch() at the top of a step, any_free(),
// dispatch() into the block's first free slot, prepare() once a step is
// neither a dispatch nor idle, free_slot() for the completion of the
// block's minimum by its owner (every thread reruns it, the others to
// padding words, finding their minimum unchanged), refill() for the
// dispatch that a completion takes into the slot it freed.
// ---------------------------------------------------------------------------

// qn_event_fast's: at most kFastSlots slots, free bits in a register
struct FlatBlock {
  static constexpr int kPad = kFastSlots;  // the padding word
  unsigned* key;
  int* user;
  unsigned free_bits, lo_key;
  int loc, usr, gone;
  uint4 q[kFastSlots / 4];  // the block's keys, read at the step's top

  __device__ __forceinline__ void init(unsigned* s_key, int* s_user, int t,
                                       int cap) {
    const unsigned k_inf = clock_key(QN_INF);
    const int bs = (cap + 31) / 32;
    const int sn = min(max(cap - t * bs, 0), bs);
    key = s_key + t * kFastStride;
    user = s_user + t * kFastStride;
#pragma unroll
    for (int k = 0; k < kFastSlots; ++k) {
      key[k] = k < sn ? k_inf : kNone;
      user[k] = -1;
    }
    free_bits = (1u << sn) - 1u;
    lo_key = sn > 0 ? k_inf : kNone;
    loc = 0;
    usr = -1;
  }

  __device__ __forceinline__ void prefetch() {
    const uint4* kv = reinterpret_cast<const uint4*>(key);
#pragma unroll
    for (int j = 0; j < kFastSlots / 4; ++j) q[j] = kv[j];
  }

  __device__ __forceinline__ bool any_free() const { return free_bits != 0; }

  __device__ __forceinline__ void dispatch(bool mine, unsigned k, int u) {
    const int l = __ffs(free_bits) - 1;                  // first free
    const int at = mine ? l : kPad;
    key[at] = k;
    user[at] = u;
    free_bits = mine ? free_bits & (free_bits - 1u) : free_bits;
    lower_min(lo_key, loc, usr, mine, k, l, u);
  }

  __device__ __forceinline__ void prepare() {}

  __device__ __forceinline__ void free_slot(bool owner) {
    const unsigned k_inf = clock_key(QN_INF);
    unsigned kk[kFastSlots];
    int ii[kFastSlots];
    gone = owner ? loc : -1;
#pragma unroll
    for (int j = 0; j < kFastSlots / 4; ++j) {
      kk[4 * j] = q[j].x;
      kk[4 * j + 1] = q[j].y;
      kk[4 * j + 2] = q[j].z;
      kk[4 * j + 3] = q[j].w;
    }
#pragma unroll
    for (int k = 0; k < kFastSlots; ++k) {
      kk[k] = k == gone ? k_inf : kk[k];
      ii[k] = k;
    }
    tree_min<kFastSlots>(kk, ii);
    gone = owner ? gone : kPad;
    key[gone] = k_inf;
    user[gone] = -1;
    free_bits |= owner ? 1u << gone : 0u;
    lo_key = kk[0];
    loc = ii[0];
    usr = user[loc];
  }

  __device__ __forceinline__ void refill(bool owner, unsigned k, int u) {
    key[gone] = k;
    user[gone] = u;
    free_bits = owner ? free_bits & ~(1u << gone) : free_bits;
    lower_min(lo_key, loc, usr, owner, k, gone, u);
  }
};

// qn_event_wide's: G groups of kFastSlots slots in dynamic shared memory
// (keys and users at stride kStride, the group minima at kGStride, the
// groups' free masks at the odd kFStride), the groups with a free slot in
// a register
template <int G>
struct GroupBlock {
  static constexpr int kSlots = G * kFastSlots;  // slots a thread, and pad
  static constexpr int kStride = kSlots + 4;     // 16-byte aligned groups
  static constexpr int kGStride = G + 4;         // pad at G
  static constexpr int kFStride = G + 1;         // pad at G
  static constexpr int kWords = 64 * kStride + 64 * kGStride + 32 * kFStride;
  unsigned *key, *gkey, *gfree;
  int *user, *gloc;
  unsigned gmask, lo_key;
  int loc, usr, gone, g;
  // the first free slot (group f_g, slot f_l; the group's free mask and
  // minimum), read at the step's top
  int f_g, f_l, f_gl;
  unsigned f_m, f_gk;
  unsigned g_k;                    // group g's fresh minimum after free_slot
  int g_l;
  uint4 q[kFastSlots / 4];         // the keys of the minimum's group

  __device__ __forceinline__ void init(unsigned* smem, int t, int cap) {
    const unsigned k_inf = clock_key(QN_INF);
    const int bs = (cap + 31) / 32;
    const int sn = min(max(cap - t * bs, 0), bs);
    key = smem + t * kStride;
    user = (int*)(smem + 32 * kStride) + t * kStride;
    gkey = smem + 64 * kStride + t * kGStride;
    gloc = (int*)(smem + 64 * kStride + 32 * kGStride) + t * kGStride;
    gfree = smem + 64 * kStride + 64 * kGStride + t * kFStride;
    for (int k = 0; k < kSlots; ++k) {
      key[k] = k < sn ? k_inf : kNone;
      user[k] = -1;
    }
    gmask = 0u;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int n = min(max(sn - kFastSlots * j, 0), kFastSlots);
      gfree[j] = (1u << n) - 1u;
      gkey[j] = n > 0 ? k_inf : kNone;
      gloc[j] = kFastSlots * j;
      gmask |= n > 0 ? 1u << j : 0u;
    }
    lo_key = sn > 0 ? k_inf : kNone;
    loc = 0;
    usr = -1;
  }

  __device__ __forceinline__ void prefetch() {
    f_g = gmask != 0 ? __ffs(gmask) - 1 : G;
    f_m = gfree[f_g];
    f_gk = gkey[f_g];
    f_gl = gloc[f_g];
    f_l = kFastSlots * f_g + __ffs(f_m) - 1;
  }

  __device__ __forceinline__ bool any_free() const { return gmask != 0; }

  __device__ __forceinline__ void dispatch(bool mine, unsigned k, int u) {
    const int l = mine ? f_l : kSlots;
    const int ga = mine ? f_g : G;
    key[l] = k;
    user[l] = u;
    const unsigned m = f_m & (f_m - 1u);
    gfree[ga] = m;
    gmask = mine && m == 0 ? gmask & ~(1u << (f_g & 31)) : gmask;
    const bool glo = before(k, f_l, f_gk, f_gl);
    gkey[ga] = glo ? k : f_gk;
    gloc[ga] = glo ? f_l : f_gl;
    lower_min(lo_key, loc, usr, mine, k, f_l, u);
  }

  __device__ __forceinline__ void prepare() {
    g = loc / kFastSlots;
    const uint4* kv = reinterpret_cast<const uint4*>(key + kFastSlots * g);
#pragma unroll
    for (int j = 0; j < kFastSlots / 4; ++j) q[j] = kv[j];
  }

  __device__ __forceinline__ void free_slot(bool owner) {
    const unsigned k_inf = clock_key(QN_INF);
    // group g without the slot that completes
    unsigned kk[kFastSlots];
    int ii[kFastSlots];
    const int out = owner ? loc - kFastSlots * g : -1;
#pragma unroll
    for (int j = 0; j < kFastSlots / 4; ++j) {
      kk[4 * j] = q[j].x;
      kk[4 * j + 1] = q[j].y;
      kk[4 * j + 2] = q[j].z;
      kk[4 * j + 3] = q[j].w;
    }
#pragma unroll
    for (int k = 0; k < kFastSlots; ++k) {
      kk[k] = k == out ? k_inf : kk[k];
      ii[k] = kFastSlots * g + k;
    }
    tree_min<kFastSlots>(kk, ii);
    g_k = kk[0];
    g_l = ii[0];
    // the block over its groups' minima, group g's fresh one stored first
    // and read back with the rest (cheaper than selecting it in)
    const int ga = owner ? g : G;
    gkey[ga] = g_k;
    gloc[ga] = g_l;
    const uint4* gk = reinterpret_cast<const uint4*>(gkey);
    const uint4* gl = reinterpret_cast<const uint4*>(gloc);
    unsigned bk[G];
    int bl[G];
#pragma unroll
    for (int j = 0; j < G / 4; ++j) {
      const uint4 a = gk[j], b = gl[j];
      bk[4 * j] = a.x;
      bk[4 * j + 1] = a.y;
      bk[4 * j + 2] = a.z;
      bk[4 * j + 3] = a.w;
      bl[4 * j] = (int)b.x;
      bl[4 * j + 1] = (int)b.y;
      bl[4 * j + 2] = (int)b.z;
      bl[4 * j + 3] = (int)b.w;
    }
    tree_min<G>(bk, bl);
    gone = owner ? loc : kSlots;
    key[gone] = k_inf;
    user[gone] = -1;
    gfree[ga] = gfree[ga] | 1u << (loc & (kFastSlots - 1));
    gmask |= owner ? 1u << g : 0u;
    lo_key = bk[0];
    loc = bl[0];
    usr = user[loc];
  }

  // no slot was free before the completion, so none is after the refill
  __device__ __forceinline__ void refill(bool owner, unsigned k, int u) {
    const int ga = owner ? g : G;
    key[gone] = k;
    user[gone] = u;
    gfree[ga] = 0u;
    gmask = owner ? 0u : gmask;
    const bool glo = before(k, gone, g_k, g_l);
    gkey[ga] = glo ? k : g_k;
    gloc[ga] = glo ? gone : g_l;
    lower_min(lo_key, loc, usr, owner, k, gone, u);
  }
};

// ---------------------------------------------------------------------------
// qn_event_fast and qn_event_wide: at most 32 users, fewer than 2^26 events
// ---------------------------------------------------------------------------

template <bool REPLAY, class Block>
__device__ __forceinline__ void lane_loop(
    Block& blk, const int* __restrict__ n_map,
    const int* __restrict__ n_reduce, const int* __restrict__ n_active,
    const float* __restrict__ m_avg, const float* __restrict__ r_avg,
    const float* __restrict__ think_ms, const float* __restrict__ think0,
    const float* __restrict__ st_m, const float* __restrict__ st_r,
    const float* __restrict__ td, float* __restrict__ resp_sum_out,
    float* __restrict__ resp_cnt_out, int H, int n_events,
    int warmup_jobs) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned below = (1u << t) - 1u;     // lanes under this one
  const unsigned user_mask = (1u << kLaneShift) - 1u;
  const unsigned k_inf = clock_key(QN_INF);

  const int nm = n_map[lane], nr = n_reduce[lane];
  const float ma = m_avg[lane], ra = r_avg[lane], tm = think_ms[lane];
  const int steps = max(0, min(n_events, n_active[lane]));

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

  // steps in blocks of 32, one block of draws each (switched here, not in
  // the step)
  for (int b = 0; b < steps; b += 32) {
    draws.block(b, t);
    const int b_end = min(b + 32, steps);
    for (int i = b; i < b_end; ++i) {
      blk.prefetch();
      const unsigned adv = advance_key(blk.lo_key, h_key);
      const unsigned g_queue = __reduce_min_sync(FULL_MASK, q_key);
      const unsigned g_adv = __reduce_min_sync(FULL_MASK, adv);
      const unsigned b_free = __ballot_sync(FULL_MASK, blk.any_free());
      const float stm_i = __uint_as_float(draws.word(0, i));
      const float str_i =
          REPLAY ? __uint_as_float(draws.word(1, i)) : stm_i;
      const float td_i = __uint_as_float(draws.word(2, i));

      const bool counted = last_done != 0 && done_jobs >= warmup_jobs;
      resp_sum = counted ? __fadd_rn(resp_sum, last_resp) : resp_sum;
      resp_cnt = counted ? __fadd_rn(resp_cnt, 1.0f) : resp_cnt;
      done_jobs += last_done != 0;
      last_done = 0;

      if (b_free != 0 && g_queue != kNone) {                 // dispatch
        const int u = (int)(g_queue & 31u);
        const bool is_map = (g_queue & kMapBit) != 0;
        const float end = REPLAY ? __fadd_rn(now, is_map ? stm_i : str_i)
                                 : __fmaf_rn(stm_i, is_map ? ma : ra, now);
        // owners' updates as selects; a thread that owns nothing writes
        // to its block's padding word
        const bool mine_u = t == u;
        pending -= mine_u;
        inflight += mine_u;
        q_key = mine_u && pending == 0 ? kNone : q_key;
        blk.dispatch(blk.any_free() && (b_free & below) == 0,
                     clock_key(end), u);
        continue;
      }
      const unsigned ka = g_adv >> 1;
      if (ka >= k_inf) continue;                             // nothing left
      blk.prepare();
      const float clock = key_clock(ka);
      const bool is_think = (g_adv & 1u) != 0;
      // the lowest lane holding the earliest end, and its user
      const unsigned g_who = __reduce_min_sync(
          FULL_MASK, adv == g_adv ? ((unsigned)t << kLaneShift) |
                                        ((is_think ? t : blk.usr) & user_mask)
                                  : kNone);
      const int w = (int)(g_who >> kLaneShift);
      const int who = (int)(g_who & user_mask);
      rank += clock != now;
      now = clock;
      if (!is_think) {                                       // completion
        blk.free_slot(t == w);
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
        if (b_free == 0 && head != kNone && i + 1 < b_end) {
          i += 1;
          const int u = (int)(head & 31u);
          const bool is_map = (head & kMapBit) != 0;
          const float st = __uint_as_float(__shfl_sync(
              FULL_MASK, REPLAY && !is_map ? draws.cur[1] : draws.cur[0],
              i & 31));
          const float end = REPLAY ? __fadd_rn(now, st)
                                   : __fmaf_rn(st, is_map ? ma : ra, now);
          const bool mine_d = t == u;
          pending -= mine_d;
          inflight += mine_d;
          q_key = mine_d && pending == 0 ? kNone : q_key;
          blk.refill(t == w, clock_key(end), u);
        }
      } else {                                               // think end
        const bool mine_u = t == w;
        phase = mine_u ? 1 : phase;
        pending = mine_u ? nm : pending;
        job_start = mine_u ? clock : job_start;
        h_key = mine_u ? k_inf : h_key;
        q_key = mine_u ? (nm > 0 ? kMapBit | (rank << 5) | (unsigned)t
                                 : kNone)
                       : q_key;
      }
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

#define QN_LANE_PARAMS                                                       \
  const int *__restrict__ n_map, const int *__restrict__ n_reduce,          \
      const int *__restrict__ slots_cap, const int *__restrict__ n_active,  \
      const float *__restrict__ m_avg, const float *__restrict__ r_avg,     \
      const float *__restrict__ think_ms, const float *__restrict__ think0, \
      const float *__restrict__ st_m, const float *__restrict__ st_r,       \
      const float *__restrict__ td, float *__restrict__ resp_sum_out,       \
      float *__restrict__ resp_cnt_out, int H, int S, int n_events,         \
      int warmup_jobs
#define QN_LANE_ARGS                                                        \
  n_map, n_reduce, n_active, m_avg, r_avg, think_ms, think0, st_m, st_r,   \
      td, resp_sum_out, resp_cnt_out, H, n_events, warmup_jobs

// at most 512 slots: a block of at most 16 slots a thread, in static
// shared memory
template <bool REPLAY>
__global__ void __launch_bounds__(32, 1) qn_event_fast(QN_LANE_PARAMS) {
  __shared__ __align__(16) unsigned s_key[32 * kFastStride];
  __shared__ int s_user[32 * kFastStride];
  FlatBlock blk;
  blk.init(s_key, s_user, threadIdx.x,
           min(max(slots_cap[blockIdx.x], 0), S));
  lane_loop<REPLAY>(blk, QN_LANE_ARGS);
}

// 513 to 16384 slots: G groups of 16 a thread, in dynamic shared memory
// (GroupBlock<G>::kWords words)
template <int G, bool REPLAY>
__global__ void __launch_bounds__(32, 1) qn_event_wide(QN_LANE_PARAMS) {
  extern __shared__ __align__(16) unsigned smem[];
  GroupBlock<G> blk;
  blk.init(smem, threadIdx.x, min(max(slots_cap[blockIdx.x], 0), S));
  lane_loop<REPLAY>(blk, QN_LANE_ARGS);
}

// ---------------------------------------------------------------------------
// qn_event_many: 33 to 2048 users, at most 16384 slots, fewer than 2^20
// events.  Its own step: the fast and wide step above keeps its user in
// registers, and sharing one step between the two user sides cost
// qn_event_fast ~1% on the card
// ---------------------------------------------------------------------------

// the first minimum of 16 unique keys (no index needed: the key names it)
__device__ __forceinline__ unsigned min16(const unsigned (&k)[16]) {
  unsigned m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = min(k[2 * j], k[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = min(m[2 * j], m[2 * j + 1]);
  return min(min(m[0], m[1]), min(m[2], m[3]));
}

__device__ __forceinline__ void load16(const unsigned* p, unsigned (&k)[16]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 a = v[j];
    k[4 * j] = a.x;
    k[4 * j + 1] = a.y;
    k[4 * j + 2] = a.z;
    k[4 * j + 3] = a.w;
  }
}

// x[g] of a register array, by selects (a runtime index would put the
// array in local memory)
template <int N, class T>
__device__ __forceinline__ T pick(const T (&x)[N], int g) {
  T r = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) r = j == g ? x[j] : r;
  return r;
}

// qn_event_many's: thread t owns users [base, base + bu), bu = ceil(H / 32)
// <= 16 UG (the users past H hold kNone keys), in UG groups of 16 in
// dynamic shared memory: six arrays (queue key, think key, pending,
// remaining tasks of the stage, phase, job start) at stride kStride, the
// padding word at kPad; past one group, each group's first minima (queue
// key; think key and its user) at stride kGStride, the padding word at UG.
// Users' indices in the arrays are local (0 .. 16 UG).  A stage ends when
// its remaining tasks reach 0, so in-flight counts need no word of their own.
// The thread's first minima of its users' queue keys (q_min; a queue key
// names its user: the map bit, the arrival rank, the user in kBits) and of
// their think keys (h_min, its user h_user()) sit in registers.  The step
// calls prefetch() at its top; dispatch(g) when the queue's head g sends a
// task; complete() for the user of a completing task (forked: a reduce
// stage forked and queued); refill() when that completion takes the
// dispatch of the new head into the slot it freed; think() for the end of
// the earliest think.  Every thread runs each call; one that owns nothing
// writes padding words
template <int UG>
struct UserBlock {
  static_assert(UG == 1 || UG == kManyGroups, "one group a thread, or four");
  static constexpr int kBits = kManyUserBits;
  static constexpr unsigned kMask = (1u << kBits) - 1u;
  static constexpr int kPad = 16 * UG;
  static constexpr int kStride = 16 * UG + 4;   // 16-byte aligned, spread
  static constexpr int kGStride = UG + 4;
  static constexpr int kWords =
      6 * 32 * kStride + (UG > 1 ? 3 * 32 * kGStride : 0);
  unsigned *qk, *hk, *gq, *gh;
  int *pend, *rem, *phase, *ghl;
  float* jst;
  int base;
  unsigned inv;              // ceil(2^20 / bu): owner(u) = u * inv >> 20
  unsigned q_min, h_min;
  int h_loc;                 // h_min's user, local
  // read at the step's top: q_min's user (local ql, its group qg, its
  // pending count qp) and its group's keys, h_loc's group's think keys,
  // the group minima
  int ql, qg, qp;
  unsigned qv[16], hv[16];
  unsigned gqv[UG], ghv[UG];
  int ghlv[UG];
  // this step's fork (complete): the user (local fl, group fg), its queue
  // key, the queue minima (block, group fg) before it
  bool forked;
  int fl, fg;
  unsigned fk, pre_q, pre_g;

  __device__ void init(unsigned* smem, const float* think0, int t, int H) {
    const int bu = max((H + 31) / 32, 1);
    const int n = min(max(H - t * bu, 0), bu);
    const size_t s = 32 * (size_t)kStride, o = (size_t)t * kStride;
    base = t * bu;
    inv = ((1u << 20) + bu - 1) / bu;
    qk = smem + o;
    hk = smem + s + o;
    pend = (int*)(smem + 2 * s) + o;
    rem = (int*)(smem + 3 * s) + o;
    phase = (int*)(smem + 4 * s) + o;
    jst = (float*)(smem + 5 * s) + o;
    gq = smem + 6 * s + t * kGStride;
    gh = smem + 6 * s + 32 * kGStride + t * kGStride;
    ghl = (int*)(smem + 6 * s + 64 * kGStride) + t * kGStride;
    for (int l = 0; l <= kPad; ++l) {
      qk[l] = kNone;
      hk[l] = l < n ? clock_key(think0[base + l]) : kNone;
      pend[l] = rem[l] = phase[l] = 0;
      jst[l] = 0.0f;
    }
    q_min = h_min = kNone;
    h_loc = 0;
    for (int g = 0; g < UG; ++g) {
      unsigned m = kNone;
      int loc = 16 * g;
      for (int l = 16 * g; l < 16 * g + 16; ++l) {
        if (hk[l] < m) {
          m = hk[l];
          loc = l;
        }
      }
      if constexpr (UG > 1) {
        gq[g] = kNone;
        gh[g] = m;
        ghl[g] = loc;
      }
      if (m < h_min) {
        h_min = m;
        h_loc = loc;
      }
    }
  }

  __device__ __forceinline__ void prefetch() {
    ql = q_min == kNone ? 0 : (int)(q_min & kMask) - base;
    qg = ql >> 4;
    qp = pend[ql];
    load16(qk + 16 * qg, qv);
    load16(hk + (h_loc & ~15), hv);
    if constexpr (UG > 1) {
      const uint4 a = *reinterpret_cast<const uint4*>(gq);
      const uint4 b = *reinterpret_cast<const uint4*>(gh);
      const uint4 c = *reinterpret_cast<const uint4*>(ghl);
      gqv[0] = a.x, gqv[1] = a.y, gqv[2] = a.z, gqv[3] = a.w;
      ghv[0] = b.x, ghv[1] = b.y, ghv[2] = b.z, ghv[3] = b.w;
      ghlv[0] = (int)c.x, ghlv[1] = (int)c.y, ghlv[2] = (int)c.z,
      ghlv[3] = (int)c.w;
    }
  }

  __device__ __forceinline__ int h_user() const { return base + h_loc; }

  __device__ __forceinline__ int owner(int u) const {
    return (int)(((unsigned)u * inv) >> 20);
  }

  // q_min's user ql leaves the queue where `gone`: group qg's minimum over
  // its other keys and `extra` (a key this step queued there), then the
  // block's over the group minima
  __device__ __forceinline__ void leave_queue(bool gone, unsigned extra) {
    unsigned k[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) k[j] = j == (ql & 15) ? kNone : qv[j];
    const unsigned m = min(min16(k), extra);
    qk[gone ? ql : kPad] = kNone;
    if constexpr (UG > 1) {
      gq[gone ? qg : UG] = m;
#pragma unroll
      for (int j = 0; j < UG; ++j) gqv[j] = gone && j == qg ? m : gqv[j];
      q_min = gone ? min(min(gqv[0], gqv[1]), min(gqv[2], gqv[3])) : q_min;
    } else {
      q_min = gone ? m : q_min;
    }
  }

  // user l (group g) joins the queue with key k where `mine`: O(1)
  __device__ __forceinline__ void join_queue(bool mine, int l, int g,
                                             unsigned k) {
    qk[mine ? l : kPad] = k;
    if constexpr (UG > 1) {
      const unsigned m = min(pick(gqv, g), k);
      gq[mine ? g : UG] = m;
#pragma unroll
      for (int j = 0; j < UG; ++j) gqv[j] = mine && j == g ? m : gqv[j];
    }
    q_min = mine ? min(q_min, k) : q_min;
  }

  __device__ __forceinline__ void dispatch(unsigned g) {
    const bool mine = q_min == g;
    const int p = qp - 1;
    pend[mine ? ql : kPad] = p;
    leave_queue(mine && p == 0, kNone);
  }

  __device__ __forceinline__ bool complete(int who, float clock, float td,
                                           float tm, int nr, unsigned rank,
                                           float* resp) {
    const bool mine = (int)threadIdx.x == owner(who);
    const int l = mine ? who - base : 0;
    const int r = rem[l] - 1;
    const int ph = phase[l];
    const float js = jst[l];
    const bool stage_done = mine && r == 0;
    const bool fork = stage_done && ph == 1;        // map stage done
    const bool job_done = stage_done && ph != 1;    // reduce stage done
    const int s = mine ? l : kPad;
    rem[s] = fork ? nr : r;
    phase[s] = fork ? 2 : job_done ? 0 : ph;
    pend[fork ? l : kPad] = nr;
    // the reduce stage queues
    fl = l;
    fg = l >> 4;
    fk = (rank << kBits) | (unsigned)who;
    forked = fork && nr > 0;
    pre_q = q_min;
    if constexpr (UG > 1) pre_g = pick(gqv, fg);
    join_queue(forked, l, fg, fk);
    // the job ends and a think starts: its key falls
    const unsigned k = clock_key(__fmaf_rn(td, tm, clock));
    hk[job_done ? l : kPad] = k;
    if constexpr (UG > 1) {
      const unsigned gk = pick(ghv, fg);
      const int gl = pick(ghlv, fg);
      const bool lo = before(k, l, gk, gl);
      gh[job_done ? fg : UG] = lo ? k : gk;
      ghl[job_done ? fg : UG] = lo ? l : gl;
    }
    const bool lo = job_done & before(k, l, h_min, h_loc);
    h_min = lo ? k : h_min;
    h_loc = lo ? l : h_loc;
    *resp = job_done ? __fsub_rn(clock, js) : 0.0f;
    return job_done;
  }

  // the dispatch of the head right after a completion: the old head
  // (g_queue, whose pending count the step's top read), or the user that
  // has just forked (its pending count nr)
  __device__ __forceinline__ void refill(unsigned head, unsigned g_queue,
                                         int nr) {
    const bool mine = q_min == head;
    if (head == g_queue) {
      const int p = qp - 1;
      pend[mine ? ql : kPad] = p;
      leave_queue(mine && p == 0, forked && fg == qg ? fk : kNone);
    } else {
      // a reduce stage of one task leaves the queue as it joined: the
      // minima go back to what they were before the fork
      const int p = nr - 1;
      pend[mine ? fl : kPad] = p;
      const bool gone = mine && p == 0;
      qk[gone ? fl : kPad] = kNone;
      if constexpr (UG > 1) gq[gone ? fg : UG] = pre_g;
      q_min = gone ? pre_q : q_min;
    }
  }

  __device__ __forceinline__ void think(bool mine, float clock, int nm,
                                        unsigned rank) {
    const int l = h_loc;
    const int s = mine ? l : kPad;
    phase[s] = 1;
    pend[s] = nm;
    rem[s] = nm;
    jst[s] = clock;
    hk[s] = clock_key(QN_INF);
    // user l's think key leaves: its group's first minimum (tree_min over
    // 16), then the block's over the group minima
    unsigned kk[16];
    int ii[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      kk[j] = j == (l & 15) ? clock_key(QN_INF) : hv[j];
      ii[j] = (l & ~15) + j;
    }
    tree_min<16>(kk, ii);
    const int g = l >> 4;
    if constexpr (UG > 1) {
      gh[mine ? g : UG] = kk[0];
      ghl[mine ? g : UG] = ii[0];
      unsigned bk[UG];
      int bl[UG];
#pragma unroll
      for (int j = 0; j < UG; ++j) {
        bk[j] = j == g ? kk[0] : ghv[j];
        bl[j] = j == g ? ii[0] : ghlv[j];
      }
      tree_min<UG>(bk, bl);
      kk[0] = bk[0];
      ii[0] = bl[0];
    }
    h_min = mine ? kk[0] : h_min;
    h_loc = mine ? ii[0] : h_loc;
    // the job's maps queue
    join_queue(mine, l, g,
               nm > 0 ? kMapBit | (rank << kBits) | (unsigned)(base + l)
                      : kNone);
  }
};

template <bool REPLAY, class Block, int UG>
__device__ __forceinline__ void many_loop(
    Block& blk, UserBlock<UG>& usr, const int* __restrict__ n_map,
    const int* __restrict__ n_reduce, const int* __restrict__ n_active,
    const float* __restrict__ m_avg, const float* __restrict__ r_avg,
    const float* __restrict__ think_ms, const float* __restrict__ st_m,
    const float* __restrict__ st_r, const float* __restrict__ td,
    float* __restrict__ resp_sum_out, float* __restrict__ resp_cnt_out,
    int n_events, int warmup_jobs) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned below = (1u << t) - 1u;     // lanes under this one
  const unsigned user_mask = (1u << kLaneShift) - 1u;
  const unsigned key_user = (1u << UserBlock<UG>::kBits) - 1u;
  const unsigned k_inf = clock_key(QN_INF);

  const int nm = n_map[lane], nr = n_reduce[lane];
  const float ma = m_avg[lane], ra = r_avg[lane], tm = think_ms[lane];
  const int steps = max(0, min(n_events, n_active[lane]));

  QnDraws draws;
  init_draws(draws, st_m, st_r, td, lane, n_events, t);
  float now = 0.0f, resp_sum = 0.0f, resp_cnt = 0.0f;
  unsigned rank = 0;          // distinct clocks so far, less one
  int done_jobs = 0;
  // a job finished by the previous step: its ballot and response, applied
  // once this step's selections are issued
  unsigned last_done = 0;
  float last_resp = 0.0f;

  // steps in blocks of 32, one block of draws each (switched here, not in
  // the step)
  for (int b = 0; b < steps; b += 32) {
    draws.block(b, t);
    const int b_end = min(b + 32, steps);
    for (int i = b; i < b_end; ++i) {
      blk.prefetch();
      usr.prefetch();
      const unsigned adv = advance_key(blk.lo_key, usr.h_min);
      const unsigned g_queue = __reduce_min_sync(FULL_MASK, usr.q_min);
      const unsigned g_adv = __reduce_min_sync(FULL_MASK, adv);
      const unsigned b_free = __ballot_sync(FULL_MASK, blk.any_free());
      const float stm_i = __uint_as_float(draws.word(0, i));
      const float str_i =
          REPLAY ? __uint_as_float(draws.word(1, i)) : stm_i;
      const float td_i = __uint_as_float(draws.word(2, i));

      const bool counted = last_done != 0 && done_jobs >= warmup_jobs;
      resp_sum = counted ? __fadd_rn(resp_sum, last_resp) : resp_sum;
      resp_cnt = counted ? __fadd_rn(resp_cnt, 1.0f) : resp_cnt;
      done_jobs += last_done != 0;
      last_done = 0;

      if (b_free != 0 && g_queue != kNone) {                 // dispatch
        const int u = (int)(g_queue & key_user);
        const bool is_map = (g_queue & kMapBit) != 0;
        const float end = REPLAY ? __fadd_rn(now, is_map ? stm_i : str_i)
                                 : __fmaf_rn(stm_i, is_map ? ma : ra, now);
        // owners' updates as selects; a thread that owns nothing writes
        // to its block's padding word
        usr.dispatch(g_queue);
        blk.dispatch(blk.any_free() && (b_free & below) == 0,
                     clock_key(end), u);
        continue;
      }
      const unsigned ka = g_adv >> 1;
      if (ka >= k_inf) continue;                             // nothing left
      blk.prepare();
      const float clock = key_clock(ka);
      const bool is_think = (g_adv & 1u) != 0;
      // the lowest lane holding the earliest end, and its user
      const unsigned g_who = __reduce_min_sync(
          FULL_MASK,
          adv == g_adv ? ((unsigned)t << kLaneShift) |
                             ((is_think ? usr.h_user() : blk.usr) & user_mask)
                       : kNone);
      const int w = (int)(g_who >> kLaneShift);
      const int who = (int)(g_who & user_mask);
      rank += clock != now;
      now = clock;
      if (!is_think) {                                       // completion
        blk.free_slot(t == w);
        // the task's user
        float resp;
        const bool job_done =
            usr.complete(who, clock, td_i, tm, nr, rank, &resp);
        last_done = __ballot_sync(FULL_MASK, job_done);
        last_resp = __shfl_sync(FULL_MASK, resp, usr.owner(who));
        // With no slot free before it, the completion leaves one free slot
        // (the one it ended); when anything is queued, the next step is a
        // dispatch into it, taken here (within the block of draws)
        const unsigned head =
            __any_sync(FULL_MASK, usr.forked)
                ? min(g_queue, (rank << UserBlock<UG>::kBits) | (unsigned)who)
                : g_queue;
        if (b_free == 0 && head != kNone && i + 1 < b_end) {
          i += 1;
          const int u = (int)(head & key_user);
          const bool is_map = (head & kMapBit) != 0;
          const float st = __uint_as_float(__shfl_sync(
              FULL_MASK, REPLAY && !is_map ? draws.cur[1] : draws.cur[0],
              i & 31));
          const float end = REPLAY ? __fadd_rn(now, st)
                                   : __fmaf_rn(st, is_map ? ma : ra, now);
          usr.refill(head, g_queue, nr);
          blk.refill(t == w, clock_key(end), u);
        }
      } else {                                               // think end
        usr.think(t == w, clock, nm, rank);
      }
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

#define QN_MANY_ARGS                                                        \
  n_map, n_reduce, n_active, m_avg, r_avg, think_ms, st_m, st_r, td,        \
      resp_sum_out, resp_cnt_out, n_events, warmup_jobs

// 33 to 2048 users: UG groups of 16 users a thread in dynamic shared
// memory (UserBlock<UG>::kWords words), after the slots' G groups of 16 a
// thread (GroupBlock<G>::kWords words) or, at G = 0 (at most 512 slots), a
// FlatBlock in static shared memory
template <int G, int UG, bool REPLAY>
__global__ void __launch_bounds__(32, 1) qn_event_many(QN_LANE_PARAMS) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ __align__(16) unsigned s_key[G == 0 ? 32 * kFastStride : 4];
  __shared__ int s_user[G == 0 ? 32 * kFastStride : 4];
  const int cap = min(max(slots_cap[blockIdx.x], 0), S);
  const float* think_lane = think0 + (size_t)blockIdx.x * H;
  UserBlock<UG> usr;
  if constexpr (G == 0) {
    FlatBlock blk;
    blk.init(s_key, s_user, threadIdx.x, cap);
    usr.init(smem, think_lane, threadIdx.x, H);
    many_loop<REPLAY>(blk, usr, QN_MANY_ARGS);
  } else {
    GroupBlock<G> blk;
    blk.init(smem, threadIdx.x, cap);
    usr.init(smem + GroupBlock<G>::kWords, think_lane, threadIdx.x, H);
    many_loop<REPLAY>(blk, usr, QN_MANY_ARGS);
  }
}

#undef QN_LANE_PARAMS
#undef QN_LANE_ARGS
#undef QN_MANY_ARGS

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

// Which kernel runs a batch, and where qn_event_general keeps a lane's
// state, in 32-bit words: slot keys and users (32 blocks of sw), free-mask
// words (32 x nwords) and six per-user arrays (32 blocks of uw).  It lives
// in dynamic shared memory when it fits the card's opt-in limit, else in a
// global scratch slice per lane.  Lanes of at most 32 users and fewer than
// 2^26 events take qn_event_fast up to 512 slots and qn_event_wide up to
// 16384 (its instance of `groups` groups of 16 slots a thread, in
// wide_words of shared memory); lanes of 33 to 2048 users and fewer than
// 2^20 events take qn_event_many up to 16384 slots (flat up to 512, else
// the same groups; ugroups groups of 16 users a thread; many_words of
// dynamic shared memory); qn_event_general takes the rest, and every batch
// asked for with general.
struct Plan {
  Route route;
  int groups, ugroups;
  bool flat;
  size_t wide_words, many_words;
  int sw, nwords, uw;
  size_t words;
  bool in_smem;
};

int plan(int h_users, int max_slots, int n_events, bool general, Plan* p) {
  const int bs = (max_slots + 31) / 32;
  p->groups = bs <= 4 * kFastSlots ? 4 : bs <= 8 * kFastSlots ? 8
              : bs <= 16 * kFastSlots ? 16 : kWideGroups;
  p->wide_words = p->groups == 4 ? GroupBlock<4>::kWords
                  : p->groups == 8 ? GroupBlock<8>::kWords
                  : p->groups == 16 ? GroupBlock<16>::kWords
                                    : GroupBlock<kWideGroups>::kWords;
  p->flat = max_slots <= 32 * kFastSlots;
  p->ugroups = h_users <= 32 * UserBlock<1>::kPad ? 1 : kManyGroups;
  p->many_words = (p->flat ? 0 : p->wide_words) +
                  (p->ugroups == 1 ? UserBlock<1>::kWords
                                   : UserBlock<kManyGroups>::kWords);
  p->sw = (bs + 3) / 4 * 4;
  p->nwords = (p->sw + 31) / 32;
  p->uw = (h_users + 31) / 32;
  p->words = 32 * (2 * (size_t)p->sw + p->nwords + 6 * (size_t)p->uw);
  int dev = 0, limit = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  p->in_smem = 4 * p->words <= (size_t)limit;
  const bool narrow = !general && h_users <= kFastUsers &&
                      n_events < (1 << kRankBits);
  const bool many = !general && h_users > kFastUsers &&
                    h_users <= kManyUsers &&
                    n_events < (1 << kManyRankBits) &&
                    max_slots <= 32 * kWideGroups * kFastSlots &&
                    4 * p->many_words <= (size_t)limit;
  p->route = many ? kMany
             : !narrow ? kGeneral
             : max_slots <= 32 * kFastSlots ? kFast
             : max_slots <= 32 * kWideGroups * kFastSlots &&
                       4 * p->wide_words <= (size_t)limit
                 ? kWide
                 : kGeneral;
  return (int)rc;
}

using LaneKernel = void (*)(const int*, const int*, const int*, const int*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, float*, float*, int, int, int,
                            int);

// the instance of qn_event_wide with `groups` groups a thread
template <bool REPLAY>
LaneKernel wide_kernel(int groups) {
  return groups == 4    ? qn_event_wide<4, REPLAY>
         : groups == 8  ? qn_event_wide<8, REPLAY>
         : groups == 16 ? qn_event_wide<16, REPLAY>
                        : qn_event_wide<kWideGroups, REPLAY>;
}

// the instance of qn_event_many with UG groups of users a thread and a
// flat slot block or `groups` groups of slots a thread
template <int UG, bool REPLAY>
LaneKernel many_instance(bool flat, int groups) {
  return flat           ? qn_event_many<0, UG, REPLAY>
         : groups == 4  ? qn_event_many<4, UG, REPLAY>
         : groups == 8  ? qn_event_many<8, UG, REPLAY>
         : groups == 16 ? qn_event_many<16, UG, REPLAY>
                        : qn_event_many<kWideGroups, UG, REPLAY>;
}

template <bool REPLAY>
LaneKernel many_kernel(const Plan& p) {
  return p.ugroups == 1
             ? many_instance<1, REPLAY>(p.flat, p.groups)
             : many_instance<kManyGroups, REPLAY>(p.flat, p.groups);
}

}  // namespace

// Bytes of global scratch each lane of qn_event_general needs (0 when its
// state fits in shared memory, as it always does where qn_event_fast,
// qn_event_wide or qn_event_many can run), or -1 when the query fails or
// the size overflows an int.
extern "C" int qn_event_scratch_bytes(int h_users, int max_slots,
                                      int n_events) {
  Plan p;
  if (plan(h_users, max_slots, n_events, true, &p) != 0) return -1;
  if (p.in_smem) return 0;
  return 4 * p.words > (size_t)0x7fffffff ? -1 : (int)(4 * p.words);
}

// *route: the kernel that ran (Route: 0 qn_event_general, 1 qn_event_fast,
// 2 qn_event_wide, 3 qn_event_many), for the wrapper's count.
extern "C" int qn_event_launch(
    const int* n_map, const int* n_reduce, const int* slots_cap,
    const int* n_active, const float* m_avg, const float* r_avg,
    const float* think_ms, const float* think0, const float* st_m,
    const float* st_r, const float* td, float* resp_sum, float* resp_cnt,
    void* scratch, int lanes, int h_users, int max_slots, int n_events,
    int warmup_jobs, int replay, int general, int* route, void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  Plan p;
  int rc = plan(h_users, max_slots, n_events, general != 0, &p);
  if (rc != 0) return rc;
  *route = p.route;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.route != kGeneral) {
    LaneKernel kernel;
    size_t smem = 0;
    if (p.route == kFast) {
      kernel = replay ? qn_event_fast<true> : qn_event_fast<false>;
    } else if (p.route == kWide) {
      kernel = replay ? wide_kernel<true>(p.groups)
                      : wide_kernel<false>(p.groups);
      smem = 4 * p.wide_words;
    } else {
      kernel = replay ? many_kernel<true>(p) : many_kernel<false>(p);
      smem = 4 * p.many_words;
    }
    if (smem > 48 * 1024) {
      rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc != 0) return rc;
    }
    kernel<<<lanes, 32, smem, s>>>(
        n_map, n_reduce, slots_cap, n_active, m_avg, r_avg, think_ms, think0,
        st_m, st_r, td, resp_sum, resp_cnt, h_users, max_slots, n_events,
        warmup_jobs);
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
