// What the fused event loops of csrc/qn_event.cu and csrc/dag_event.cu
// share (one warp a lane, the lane's slots cut into 32 contiguous blocks,
// one a thread; only the owner writes a block): the clock keys, the
// earliest-end key, the draw tables read 32 events ahead, a thread's block
// of at most kFastSlots slots in registers' reach (the fast kernels:
// tree_min) and a thread's block of slots in memory (the general kernels:
// Slots).
//
// Keys: every clock is non-negative (times from non-negative draws and
// means), so clearing the sign bit of the float gives an unsigned key
// that orders exactly as float < does, -0.0 folded into +0.0, the
// sentinel QN_INF and +inf included.  0xffffffff (above every key) marks
// an empty block or a user with nothing queued.
#pragma once

#include <cuda_runtime.h>

#define QN_INF 1e30f
#define FULL_MASK 0xffffffffu

namespace {

constexpr unsigned kNone = 0xffffffffu;
constexpr int kFastSlots = 16;   // slots a thread of a fast kernel holds
constexpr int kFastStride = 20;  // its block's stride in words (16-byte
                                 // aligned, spreads the banks)

__device__ __forceinline__ unsigned clock_key(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

__device__ __forceinline__ float key_clock(unsigned k) {
  return __uint_as_float(k);
}

// (key, local index) -> keep the smaller key, the lower index on ties
__device__ __forceinline__ void take_min(unsigned& m, int& loc, unsigned k,
                                         int l) {
  if (k < m || (k == m && l < loc)) {
    m = k;
    loc = l;
  }
}

// The earliest slot end and think end as one key: the clock key shifted
// up, a think marked in the low bit, so that a slot end sorts before an
// equal think end.
__device__ __forceinline__ unsigned advance_key(unsigned slot_min,
                                                unsigned think_min) {
  const unsigned s = slot_min == kNone ? kNone : slot_min << 1;
  const unsigned h = think_min == kNone ? kNone : (think_min << 1) | 1u;
  return min(s, h);
}

// (key[0], loc[0]) = the first minimum of key[0..W): contiguous halves
// merge pairwise, the right half winning only with a smaller key
template <int W, int STRIDE = 1>
__device__ __forceinline__ void tree_min(unsigned* key, int* loc) {
  if constexpr (STRIDE < W) {
#pragma unroll
    for (int k = 0; k < W; k += 2 * STRIDE) {
      if (key[k + STRIDE] < key[k]) {
        key[k] = key[k + STRIDE];
        loc[k] = loc[k + STRIDE];
      }
    }
    tree_min<W, 2 * STRIDE>(key, loc);
  }
}

// N draw tables of one lane, 32-bit words, read 32 events ahead: thread t
// holds event 32*b + t of the current block b (cur) and of the next (nxt);
// word(k, i) broadcasts step i's word of table k with __shfl_sync.  A loop
// over blocks of 32 steps switches blocks once a block (block()); at(i)
// switches where i % 32 == 0, inside a loop over steps.
template <int N>
struct Draws {
  const unsigned* tab[N];
  int n;
  unsigned cur[N], nxt[N];

  __device__ void init(const unsigned* const (&tables)[N], int lane,
                       int n_events, int t) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      tab[k] = tables[k] + (size_t)lane * n_events;
      cur[k] = nxt[k] = 0u;
    }
    n = n_events;
    if (n > 0) fetch(t);
  }

  __device__ __forceinline__ void fetch(int e) {
    e = min(e, n - 1);
#pragma unroll
    for (int k = 0; k < N; ++k) nxt[k] = tab[k][e];
  }

  // the block of events from b (a multiple of 32) becomes the current one,
  // and this thread's word of the next block is fetched
  __device__ __forceinline__ void block(int b, int t) {
#pragma unroll
    for (int k = 0; k < N; ++k) cur[k] = nxt[k];
    fetch(b + 32 + t);
  }

  // table k's word of step i (in the current block), on every thread
  __device__ __forceinline__ unsigned word(int k, int i) const {
    return __shfl_sync(FULL_MASK, cur[k], i & 31);
  }

  // step i's words, on every thread, a block switched at i % 32 == 0
  __device__ __forceinline__ void at(int i, int t, unsigned (&out)[N]) {
    if ((i & 31) == 0) block(i, t);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = word(k, i);
  }
};

// This thread's slots: global indices [base, base + n), keys and users at
// stride sw, free-mask words beside them.
struct Slots {
  unsigned* key;       // clock_key of the slot's end, QN_INF when idle
  int* user;           // the task's user, -1 when free
  unsigned* mask;      // free bits
  int base, n, nw;
  unsigned min_key;    // the block's earliest end
  int min_loc, min_user;
  int free_loc;        // the block's first free slot, or -1

  __device__ void init(unsigned* region, int t, int sw, int nwords,
                       int cap) {
    const int bs = (cap + 31) / 32;
    base = t * bs;
    n = min(max(cap - base, 0), bs);
    key = region + (size_t)t * sw;
    user = (int*)(region + 32 * (size_t)sw) + (size_t)t * sw;
    nw = nwords;
    mask = region + 64 * (size_t)sw + (size_t)t * nwords;
    for (int k = 0; k < n; ++k) {
      key[k] = clock_key(QN_INF);
      user[k] = -1;
    }
    for (int w = 0; w < nw; ++w) {
      const int left = n - 32 * w;
      mask[w] = left >= 32 ? FULL_MASK : left > 0 ? (1u << left) - 1u : 0u;
    }
    free_loc = n > 0 ? 0 : -1;
    min_key = n > 0 ? clock_key(QN_INF) : kNone;
    min_loc = 0;
    min_user = -1;
  }

  __device__ __forceinline__ unsigned free_key() const {
    return free_loc < 0 ? kNone : (unsigned)(base + free_loc);
  }

  // the block's first earliest end, and its user (read here, so that a
  // later completion has it in a register)
  __device__ __forceinline__ void rescan() {
    unsigned m = kNone;
    int loc = 0;
    for (int k = 0; k < n; ++k) {
      const unsigned x = key[k];
      if (x < m) {
        m = x;
        loc = k;
      }
    }
    min_key = m;
    min_loc = loc;
    min_user = user[loc];
  }

  // a task of user u starts in the first free slot, ending at `end`
  __device__ __forceinline__ void dispatch(float end, int u) {
    const int l = free_loc;
    const unsigned k = clock_key(end);
    key[l] = k;
    user[l] = u;
    if (k < min_key || (k == min_key && l < min_loc)) {
      min_key = k;
      min_loc = l;
      min_user = u;
    }
    int w = l >> 5;
    mask[w] &= ~(1u << (l & 31));
    free_loc = -1;
    for (; w < nw; ++w) {
      const unsigned m = mask[w];
      if (m) {
        free_loc = 32 * w + __ffs(m) - 1;
        break;
      }
    }
  }

  // the earliest-ending task (its user is min_user) completes
  __device__ __forceinline__ void complete() {
    const int l = min_loc;
    key[l] = clock_key(QN_INF);
    user[l] = -1;
    mask[l >> 5] |= 1u << (l & 31);
    free_loc = (free_loc < 0 || l < free_loc) ? l : free_loc;
    rescan();
  }
};

}  // namespace
