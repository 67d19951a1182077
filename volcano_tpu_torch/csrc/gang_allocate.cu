// Gang-allocate kernel for NVIDIA Hopper (sm_90a).
//
// Replaces volcano_tpu/ops/pallas_allocate.py:_kernel, the TPU kernel that
// runs the whole allocate loop as one sequential grid. The semantics are
// those of the plain PyTorch loop volcano_tpu_torch/ops/allocate.py:
// gang_allocate, which is its plain version and is held against it:
//
//   for each task step of the current job: fit (idle and future capacity,
//   pod cap, static mask) and score (binpack + least + most + balanced +
//   static + topology pack bonus) over every node, argmax with the lowest
//   node index on ties, pipelining onto future capacity when nothing fits
//   idle, then the node-state update; at the job's end the gang
//   ready/kept decision, the rollback when the gang fails, the queue and
//   namespace charge, and the next (namespace, queue) pool's job.
//
// Design: ONE thread-block cluster of B blocks of 512 threads, launched
// once per placement; the task axis is a loop inside it. B is 8 while a
// block holds at most 512 nodes, else 16 (ops/cuda_allocate.py:
// cluster_plan). Block b owns the contiguous node range [b*nb, (b+1)*nb)
// and keeps its node state (idle, future, alloc, pod count and cap, pack
// row) in its shared memory for the whole launch; block 0 also keeps the
// fair-share state (queue and namespace allocations, pool cursors).
//
// Most steps do not sweep the nodes. The decision procedure is that of
// volcano_tpu/ops/sharded.py:_sharded_body_chunked (ops/allocate.py:
// gang_allocate_chunked is its plain model): a REFRESH sweeps every node
// once and keeps the top kC = 16 nodes per fit class (idle, future; score
// descending, node index ascending); up to kC steps are then SERVED from
// that table by one warp of block 0 alone, with no barrier. A valid step
// refreshes after a rollback, after kC served steps, and when the group,
// the bucket or the task's domain slot changed; an invalid (padding) step
// serves nothing and passes the refresh it needed on. The table is exact,
// ties included: only placed-on nodes change within a chunk, and they are
// in the table; the table kept kC candidates a class, of which at most
// kC - 1 were touched, so an untouched node outside it never beats its
// best (sharded.py:277-293).
//
// Domain slots (the constraint compiler's task_slot [T] and slot_ok
// [S+1, N], ops/constraints.py): task t may use only the nodes of row
// task_slot[t]. The refresh masks every node with the row of the step's
// slot, read from global memory (once a refresh, like the group's mask
// row); a slot change forces a refresh, so a served step's table was
// always built under its own slot and a served step reads no slot row.
// An all-false row gives an empty table: the task fails, and its gang
// pipelines or rolls back as if the domain were full.
//
// A refresh: the serving warp publishes the step (group, same-bucket flag,
// pack generation, slot) to every block and all meet at cluster.sync(). Each
// block sweeps its nodes, one a lane in batches of 32 a warp, keeps a
// running sorted top-kC per warp by bitonic sort and merge in registers
// (a batch that beats nothing is skipped, and while no node's future
// differs from its idle one sort serves both classes), merges its warps'
// lists in a tree in shared memory and writes its 32 rows (16 a class)
// into block 0's table over distributed shared memory; all meet again, and
// block 0 merges the blocks' lists into the 16 best rows a class.
//
// A served step: lane L of the serving warp holds row L (lanes 0-15 the
// idle class, 16-31 the future class) with its node's state, fit bits and
// score in registers. The warp takes the argmax of both classes by
// shuffles; the placed node's rows take the placement, its owner block's
// shared memory takes the new state (a DSMEM store, seen after the next
// cluster.sync()), and the next step rescores that node alone, its
// divisions spread over the lanes (every row when "same bucket" flips).
// The pool select, gang check and charges run on the whole warp too.
//
// Rollback: each placement logs the node's previous state to an undo log
// in device memory; a failed gang replays it backwards into the owner
// blocks, and the next step refreshes. A commit costs nothing. The pack
// row is reset by bumping a generation number: a node's pack counts only
// when its generation is the current one.
//
// What bounds it on an H100: the steps are strictly dependent. A served
// step is a chain of latencies in one warp (the task's loads, one node's
// score, the shuffle argmax, the placement's stores, the job boundary's
// loads); a refresh is a sweep of nb nodes (about 80 float operations
// each, ten IEEE divisions) on each of B SMs, the top-kC merges and two
// cluster barriers. The card-wide floors (each input read once over HBM,
// the operations over the float32 peak) are far below both.
//
// Floating point: build with -fmad=false. Every score, in the sweep and in
// a served step, is computed in the operation order of ops/score.py:
// node_score (score_of, and score_of_warp, which only moves its divisions
// to other lanes), one rounding per operation, so that the kernel and the
// plain PyTorch version round alike on the card and break argmax ties
// alike.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 16;          // candidates a block keeps per fit class
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;  // node index of "no candidate"
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDescWords = 5;  // kind, group, same bucket, pack generation, slot
constexpr int kReqWords = 2 * 8 + 6;  // a Req<R> at the largest R
constexpr int kRefresh = 0, kDone = 1;

static_assert(2 * kC == 32, "a block's table rows are one warp's lanes");

struct Args {
  // task axis [T]
  const int32_t* task_group;
  const uint8_t* task_valid;
  const int32_t* task_bucket;
  const int32_t* task_job;
  const int32_t* task_slot;       // [T] domain slot, or null: no slots
  const uint8_t* slot_ok;         // [S+1, N] the slots' node rows
  // group axis
  const float* group_req;         // [G, R]
  const uint8_t* group_mask;      // [G, N]
  const float* group_static;      // [G, N]
  const float* group_pack_bonus;  // [G]
  // job axis [J]
  const int32_t* job_min_available;
  const int32_t* job_ready_base;
  const int32_t* job_task_start;
  const int32_t* job_n_tasks;
  // pools [P], namespaces [NS], queues [Q]
  const int32_t* pool_queue;
  const int32_t* pool_ns;
  const int32_t* pool_job_start;
  const int32_t* pool_njobs;
  const float* ns_weight;         // [NS]
  const float* ns_total;          // [R]
  const float* queue_deserved;    // [Q, R], +inf = ungated
  // nodes, [N, R] and [N]
  const float* node_idle;
  const float* node_future;
  const float* node_alloc;
  const int32_t* node_ntasks;
  const int32_t* node_max_tasks;  // 0 = uncapped
  const float* eps;               // [R]
  const float* weights;           // [4 + R]: binpack, least, most, balanced, binpack_res
  // outputs: final node state
  float* out_idle;                // [N, R]
  float* out_future;              // [N, R]
  int32_t* out_ntasks;            // [N]
  // scratch: one undo entry (node, pods, idle[R], future[R]) per task
  float* undo;                    // [T, 2 + 2R]
  // fair-share state, updated in place (q_alloc, ns_alloc hold the
  // initial values on entry)
  float* q_alloc;                 // [Q, R]
  float* ns_alloc;                // [NS, R]
  int32_t* p_cursor;              // [P]
  // outputs
  int32_t* assign;                // [T]
  uint8_t* pipelined;             // [T]
  uint8_t* ready;                 // [J]
  uint8_t* kept;                  // [J]
  // what the launch did: table refreshes, the cluster's blocks and each
  // block's dynamic shared memory in bytes
  int32_t* stats;                 // [3]
  int T, J, P, NS, Q, N, S;
  int allow_pipeline, ns_live;
  int nb;                         // nodes a block owns
};

// The request of one group and the score weights it takes.
template <int R>
struct Req {
  static_assert(2 * R + 6 <= kReqWords, "Req must fit its shared words");
  float req[R], w[R], wsum, bonus;
  float w_binpack, w_least, w_most, w_balanced;

  __device__ Req(const Args& a, int g) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      req[r] = __ldg(a.group_req + g * R + r);
      float wr = __ldg(a.weights + 4 + r);
      w[r] = (req[r] > 0.0f && wr > 0.0f) ? wr : 0.0f;
      wsum = (r == 0) ? w[r] : wsum + w[r];
    }
    wsum = fmaxf(wsum, 1e-9f);
    bonus = __ldg(a.group_pack_bonus + g);
    w_binpack = __ldg(a.weights + 0);
    w_least = __ldg(a.weights + 1);
    w_most = __ldg(a.weights + 2);
    w_balanced = __ldg(a.weights + 3);
  }

  // fits: req <= cap + eps in every resource
  __device__ bool fits(const float (&cap)[R], const float (&eps)[R]) const {
    bool ok = true;
#pragma unroll
    for (int r = 0; r < R; ++r) ok &= req[r] <= cap[r] + eps[r];
    return ok;
  }

  // ops/score.py:node_score, operation for operation; stat_eff is the
  // static score plus pack * bonus
  __device__ float score_of(const float (&idle)[R], const float (&alloc)[R],
                            float stat_eff) const {
    float used[R];
    float num = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      used[r] = alloc[r] - idle[r];
      float frac = alloc[r] > 0.0f
                       ? (used[r] + req[r]) / fmaxf(alloc[r], 1e-9f)
                       : 2.0f;
      float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
      num = (r == 0) ? per * w[r] : num + per * w[r];
    }
    float lr[2], mr[2], fr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float al = alloc[r];
      float u = used[r] + req[r];
      float den = fmaxf(al, 1e-9f);
      lr[r] = (al > 0.0f ? fmaxf(al - u, 0.0f) / den : 0.0f) * 100.0f;
      mr[r] = (al > 0.0f ? fminf(fmaxf(u, 0.0f), al) / den : 0.0f) * 100.0f;
      fr[r] = al > 0.0f ? u / den : 0.0f;
    }
    float s = w_binpack * (num / wsum);
    s = s + w_least * ((lr[0] + lr[1]) / 2.0f);
    s = s + w_most * ((mr[0] + mr[1]) / 2.0f);
    s = s + w_balanced * (100.0f - fabsf(fr[0] - fr[1]) * 100.0f);
    return s + stat_eff;
  }

  // score_of for the node held by lane `src`, computed by the whole warp
  // (every lane gets it): each of its R + 6 divisions runs on a lane of
  // its own, then the terms are summed in score_of's order
  __device__ float score_of_warp(const float (&idle_src)[R],
                                 const float (&alloc_src)[R],
                                 float stat_eff_src, int src, int lane) const {
    float idle[R], alloc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      idle[r] = __shfl_sync(kFull, idle_src[r], src);
      alloc[r] = __shfl_sync(kFull, alloc_src[r], src);
    }
    const float stat_eff = __shfl_sync(kFull, stat_eff_src, src);
    float num = 1.0f, den = 1.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float used = alloc[r] - idle[r];
      const float u = used + req[r];
      const float d = fmaxf(alloc[r], 1e-9f);
      if (lane == r) {
        num = u;
        den = d;
      }
      if (r < 2) {
        if (lane == R + r) {
          num = fmaxf(alloc[r] - u, 0.0f);
          den = d;
        }
        if (lane == R + 2 + r) {
          num = fminf(fmaxf(u, 0.0f), alloc[r]);
          den = d;
        }
        if (lane == R + 4 + r) {
          num = u;
          den = d;
        }
      }
    }
    const float quo = num / den;
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float qr = __shfl_sync(kFull, quo, r);
      float frac = alloc[r] > 0.0f ? qr : 2.0f;
      float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
      acc = (r == 0) ? per * w[r] : acc + per * w[r];
    }
    float lr[2], mr[2], fr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ql = __shfl_sync(kFull, quo, R + r);
      const float qm = __shfl_sync(kFull, quo, R + 2 + r);
      const float qf = __shfl_sync(kFull, quo, R + 4 + r);
      const bool pos = alloc[r] > 0.0f;
      lr[r] = (pos ? ql : 0.0f) * 100.0f;
      mr[r] = (pos ? qm : 0.0f) * 100.0f;
      fr[r] = pos ? qf : 0.0f;
    }
    float s = w_binpack * (acc / wsum);
    s = s + w_least * ((lr[0] + lr[1]) / 2.0f);
    s = s + w_most * ((mr[0] + mr[1]) / 2.0f);
    s = s + w_balanced * (100.0f - fabsf(fr[0] - fr[1]) * 100.0f);
    return s + stat_eff;
  }
};

// Dynamic shared memory of a block, in 4-byte words; ops/cuda_allocate.py:
// cluster_plan computes the same size.
__host__ __device__ inline int shared_words(int nb, int blocks, int R, int Q,
                                            int NS, int P) {
  return (3 * R + 4) * nb + (3 * R + 7) * 2 * kC * blocks +
         kWarps * 2 * kC * 2 + kDescWords + kReqWords + (Q + NS) * R + P;
}

template <int R>
struct Smem {
  // this block's nodes: [R][nb] and [nb]
  float* idle;
  float* fut;
  float* alloc;
  int* ntasks;
  int* maxt;
  float* pack;
  int* pgen;       // the pack entry counts only in this generation
  // the candidate table (block 0's is the one used): [K] and [R][K]
  int* t_gidx;     // node index, -1 = no candidate
  float* t_static;
  float* t_pack;   // pack at the refresh, plus the chunk's placements
  int* t_nt;
  int* t_maxt;
  float* t_idle;
  float* t_fut;
  float* t_alloc;
  float* t_score;  // cached score of the row
  int* t_fit;      // bit 0 fits idle, bit 1 fits future
  // the warps' candidate lists, [kWarps][2][kC]
  float* m_s;
  int* m_i;
  int* desc;       // [kDescWords] the step a refresh serves
  Req<R>* q;       // the request of the group the table was built for
  // block 0: the fair-share state
  float* q_alloc;  // [Q, R]
  float* ns_alloc; // [NS, R]
  int* p_cursor;   // [P]

  __device__ Smem(float* f, const Args& a, int K) {
    const int nb = a.nb;
    idle = f; f += R * nb;
    fut = f; f += R * nb;
    alloc = f; f += R * nb;
    ntasks = reinterpret_cast<int*>(f); f += nb;
    maxt = reinterpret_cast<int*>(f); f += nb;
    pack = f; f += nb;
    pgen = reinterpret_cast<int*>(f); f += nb;
    t_gidx = reinterpret_cast<int*>(f); f += K;
    t_static = f; f += K;
    t_pack = f; f += K;
    t_nt = reinterpret_cast<int*>(f); f += K;
    t_maxt = reinterpret_cast<int*>(f); f += K;
    t_idle = f; f += R * K;
    t_fut = f; f += R * K;
    t_alloc = f; f += R * K;
    t_score = f; f += K;
    t_fit = reinterpret_cast<int*>(f); f += K;
    m_s = f; f += kWarps * 2 * kC;
    m_i = reinterpret_cast<int*>(f); f += kWarps * 2 * kC;
    desc = reinterpret_cast<int*>(f); f += kDescWords;
    q = reinterpret_cast<Req<R>*>(f); f += kReqWords;
    q_alloc = f; f += a.Q * R;
    ns_alloc = f; f += a.NS * R;
    p_cursor = reinterpret_cast<int*>(f);
  }
};

// ---- candidate order: score descending, then node index ascending

__device__ __forceinline__ bool beats(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void better_of(float& s, int& i, float s2, int i2) {
  if (beats(s2, i2, s, i)) {
    s = s2;
    i = i2;
  }
}

// every lane ends with the warp's best
__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(kFull, s, off);
    int i2 = __shfl_xor_sync(kFull, i, off);
    better_of(s, i, s2, i2);
  }
}

// compare-exchange with lane ^ j: keep the better key when `keep_better`
__device__ __forceinline__ void cmpx(float& s, int& i, int j,
                                     bool keep_better) {
  float s2 = __shfl_xor_sync(kFull, s, j);
  int i2 = __shfl_xor_sync(kFull, i, j);
  if (beats(s2, i2, s, i) == keep_better) {
    s = s2;
    i = i2;
  }
}

// bitonic sort of the warp's 32 keys, best in lane 0
__device__ __forceinline__ void sort32(float& s, int& i, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
      cmpx(s, i, j, ((lane & j) == 0) == ((lane & k) == 0));
}

// sorts a bitonic sequence over the warp (descending, then ascending)
__device__ __forceinline__ void merge32(float& s, int& i, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) cmpx(s, i, j, (lane & j) == 0);
}

// Offer one batch of 32 keys (one a lane) to the warp's running list, the
// best kC in lanes 0..kC-1 in order. A batch that beats none of them is
// skipped.
__device__ __forceinline__ void offer(float& as, int& ai, float ks, int ki,
                                      int lane) {
  float ts = __shfl_sync(kFull, as, kC - 1);
  int ti = __shfl_sync(kFull, ai, kC - 1);
  if (!__any_sync(kFull, beats(ks, ki, ts, ti))) return;
  sort32(ks, ki, lane);
  float bs = __shfl_sync(kFull, ks, 31 - lane);
  int bi = __shfl_sync(kFull, ki, 31 - lane);
  if (lane >= kC) {
    as = bs;
    ai = bi;
  }
  merge32(as, ai, lane);
}

template <int R>
__device__ float queue_share(const float* alloc, const float* des) {
  float m = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float d = des[r], a = alloc[r];
    float f = isinf(d) ? 0.0f : (d == 0.0f ? (a == 0.0f ? 0.0f : 1.0f) : a / d);
    m = (r == 0) ? f : fmaxf(m, f);
  }
  return m;
}

template <int R>
__device__ bool queue_overused(const float* alloc, const float* des,
                               const float* eps) {
  bool over = false;
#pragma unroll
  for (int r = 0; r < R; ++r)
    over |= !((alloc[r] <= des[r] + eps[r]) || isinf(des[r]));
  return over;
}

// ops/allocate.make_pool_select: namespace first, then the least-share
// non-overused pool in it; lowest index on ties at both levels. Run by the
// whole serving warp, one pool a lane; every lane gets the result.
template <int R>
__device__ int select_pool(const Args& a, const Smem<R>& S, const float* eps,
                           int* job, int lane) {
  auto pool_ok = [&](int p) {
    int q = __ldg(a.pool_queue + p);
    return S.p_cursor[p] < __ldg(a.pool_njobs + p) &&
           !queue_overused<R>(S.q_alloc + q * R, a.queue_deserved + q * R, eps);
  };
  int ns_sel = 0;
  float best = INFINITY;
  bool sel_has = false;
  for (int n = 0; n < a.NS; ++n) {
    bool has = false;
    for (int base = 0; base < a.P && !has; base += 32) {
      const int p = base + lane;
      has = __any_sync(kFull,
                       p < a.P && __ldg(a.pool_ns + p) == n && pool_ok(p));
    }
    float key = kBig;
    if (has) {
      if (a.ns_live) {
        float m = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float t = __ldg(a.ns_total + r), al = S.ns_alloc[n * R + r];
          float f = t > 0.0f ? al / t : (al == 0.0f ? 0.0f : 1.0f);
          m = (r == 0) ? f : fmaxf(m, f);
        }
        key = m / __ldg(a.ns_weight + n);
      } else {
        key = (float)n;
      }
    }
    if (key < best) {
      best = key;
      ns_sel = n;
      sel_has = has;
    }
  }
  if (!sel_has) {
    *job = -1;
    return -1;
  }
  // the least (share, pool) over every pool, ineligible ones at kBig
  float key = INFINITY;
  int p_sel = kNone;
  for (int base = 0; base < a.P; base += 32) {
    const int p = base + lane;
    if (p >= a.P) break;
    float k = kBig;
    if (__ldg(a.pool_ns + p) == ns_sel && pool_ok(p)) {
      int q = __ldg(a.pool_queue + p);
      k = queue_share<R>(S.q_alloc + q * R, a.queue_deserved + q * R);
    }
    if (k < key) {
      key = k;
      p_sel = p;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float k2 = __shfl_xor_sync(kFull, key, off);
    int p2 = __shfl_xor_sync(kFull, p_sel, off);
    if (k2 < key || (k2 == key && p2 < p_sel)) {
      key = k2;
      p_sel = p2;
    }
  }
  *job = __ldg(a.pool_job_start + p_sel) + S.p_cursor[p_sel];
  return p_sel;
}

// Merge n sorted lists of kC keys per class, list l of class c at
// [(l * 2 + c) * kC], in a tree (list w takes list w + half) into list 0;
// one warp a merge, the block's threads all taking part.
template <int n>
__device__ __forceinline__ void merge_lists(float* m_s, int* m_i, int warp,
                                            int lane) {
#pragma unroll
  for (int half = n / 2; half >= 1; half >>= 1) {
    if (warp < 2 * half) {
      const int c = warp / half, w = warp % half;
      const int src = lane < kC ? (w * 2 + c) * kC + lane
                                : ((w + half) * 2 + c) * kC + (31 - lane);
      float s = m_s[src];
      int i = m_i[src];
      merge32(s, i, lane);
      if (lane < kC) {
        m_s[(w * 2 + c) * kC + lane] = s;
        m_i[(w * 2 + c) * kC + lane] = i;
      }
    }
    __syncthreads();
  }
}

// After a refresh, in block 0: the blocks' lists (rows b*32 + c*kC + k of
// the table, in order) merged into the top kC rows per class over all
// nodes, as (score, row) keys in list 0 of the scratch. Within a class the
// row order is the node order among equal scores, so ties still go to the
// lowest node index.
template <int R, int B>
__device__ void merge_blocks(const Smem<R>& S, int tid, int warp, int lane) {
  if (tid < 2 * kC * B) {
    const int b = tid / (2 * kC), c = (tid / kC) & 1;
    const bool live = S.t_gidx[tid] >= 0;
    S.m_s[(b * 2 + c) * kC + (tid % kC)] = live ? S.t_score[tid] : -INFINITY;
    S.m_i[(b * 2 + c) * kC + (tid % kC)] = live ? tid : kNone;
  }
  __syncthreads();
  merge_lists<B>(S.m_s, S.m_i, warp, lane);
}

// A refresh, in every block: sweep the block's nodes, keep the top kC per
// fit class, and write them as rows rank*32 .. rank*32+31 of block 0's
// table (lanes 0..15 the idle class, 16..31 the future class).
template <int R, int B>
__device__ void refresh(const Args& a, const Smem<R>& S,
                        cg::cluster_group& cluster, const float (&eps)[R],
                        int rank, int lo, int n_local) {
  constexpr int K = 2 * kC * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nb;
  const int g = S.desc[1], sb = S.desc[2], gen = S.desc[3];
  const int slot = S.desc[4];
  const Req<R> q(a, g);
  if (rank == 0 && threadIdx.x == 0) *S.q = q;
  const uint8_t* mask_row = a.group_mask + (size_t)g * a.N;
  // the step's domain row; a slot outside 0..S admits no node
  const bool slot_in = a.task_slot == nullptr || (slot >= 0 && slot <= a.S);
  const uint8_t* slot_row =
      a.task_slot != nullptr && slot_in ? a.slot_ok + (size_t)slot * a.N
                                        : nullptr;
  const float* static_row = a.group_static + (size_t)g * a.N;

  float as_i = -INFINITY, as_f = -INFINITY;
  int ai_i = kNone, ai_f = kNone;
  const int batches = (n_local + 31) / 32;
  // the keys of this lane's node in batch bt: (score, node) in each fit
  // class it fits, else (-inf, kNone); no branch around the loads and the
  // score, so that their latencies overlap
  auto key_of = [&](int bt, float& ks_i, int& ki_i, float& ks_f, int& ki_f) {
    const int li = bt * 32 + lane;
    const bool real = bt < batches && li < n_local;
    const int lc = real ? li : 0;
    // read once a refresh: kept out of L1, which holds the serving
    // warp's task and job arrays
    // (slot_row is the same for the whole cluster: no divergence)
    const bool in_slot =
        slot_row == nullptr || __ldcg(slot_row + lo + lc) != 0;
    const bool in_mask =
        slot_in & (__ldcg(mask_row + lo + lc) != 0) & in_slot;
    const float stat = __ldcg(static_row + lo + lc);
    const int nt = S.ntasks[lc], maxt = S.maxt[lc];
    const float pk = (sb && S.pgen[lc] == gen) ? S.pack[lc] : 0.0f;
    float idle[R], fut[R], alloc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      idle[r] = S.idle[r * nb + lc];
      fut[r] = S.fut[r * nb + lc];
      alloc[r] = S.alloc[r * nb + lc];
    }
    const bool ok = real & in_mask & ((maxt == 0) | (nt < maxt));
    const bool fi = ok & q.fits(idle, eps);
    const bool ff = ok & (a.allow_pipeline != 0) & q.fits(fut, eps);
    const float s = q.score_of(idle, alloc, stat + pk * q.bonus);
    ks_i = fi ? s : -INFINITY;
    ki_i = fi ? lo + li : kNone;
    ks_f = ff ? s : -INFINITY;
    ki_f = ff ? lo + li : kNone;
  };
  // while every batch so far gave both classes the same keys (no node's
  // future differs from its idle in a way that matters), the two running
  // lists are equal and one sort serves both
  bool twin = true;
  for (int bt = warp; bt < batches; bt += kWarps) {
    float ks_i, ks_f;
    int ki_i, ki_f;
    key_of(bt, ks_i, ki_i, ks_f, ki_f);
    twin = twin && __all_sync(kFull, ks_i == ks_f && ki_i == ki_f);
    offer(as_i, ai_i, ks_i, ki_i, lane);
    if (twin) {
      as_f = as_i;
      ai_f = ai_i;
    } else {
      offer(as_f, ai_f, ks_f, ki_f, lane);
    }
  }
  if (lane < kC) {
    S.m_s[(warp * 2 + 0) * kC + lane] = as_i;
    S.m_i[(warp * 2 + 0) * kC + lane] = ai_i;
    S.m_s[(warp * 2 + 1) * kC + lane] = as_f;
    S.m_i[(warp * 2 + 1) * kC + lane] = ai_f;
  }
  __syncthreads();
  merge_lists<kWarps>(S.m_s, S.m_i, warp, lane);
  if (warp != 0) return;
  // the block's 32 rows, one a lane, into block 0's table
  const int row = rank * 2 * kC + lane;
  const float s = S.m_s[lane];   // list 0: [class][kC] = lane
  const int gi = S.m_i[lane];
  int* t_gidx = cluster.map_shared_rank(S.t_gidx, 0);
  int* t_fit = cluster.map_shared_rank(S.t_fit, 0);
  if (gi == kNone) {
    t_gidx[row] = -1;
    t_fit[row] = 0;
    return;
  }
  const int li = gi - lo;
  const int nt = S.ntasks[li], maxt = S.maxt[li];
  float idle[R], fut[R];
  float* t_idle = cluster.map_shared_rank(S.t_idle, 0);
  float* t_fut = cluster.map_shared_rank(S.t_fut, 0);
  float* t_alloc = cluster.map_shared_rank(S.t_alloc, 0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    idle[r] = S.idle[r * nb + li];
    fut[r] = S.fut[r * nb + li];
    t_idle[r * K + row] = idle[r];
    t_fut[r * K + row] = fut[r];
    t_alloc[r * K + row] = S.alloc[r * nb + li];
  }
  // a candidate passed the mask, so its fits hang on the pod cap alone
  const bool ok = (maxt == 0) | (nt < maxt);
  const int fit = (ok && q.fits(idle, eps) ? 1 : 0) |
                  (ok && a.allow_pipeline && q.fits(fut, eps) ? 2 : 0);
  t_gidx[row] = gi;
  t_fit[row] = fit;
  cluster.map_shared_rank(S.t_static, 0)[row] = __ldcg(static_row + gi);
  cluster.map_shared_rank(S.t_pack, 0)[row] =
      (sb && S.pgen[li] == gen) ? S.pack[li] : 0.0f;
  cluster.map_shared_rank(S.t_nt, 0)[row] = nt;
  cluster.map_shared_rank(S.t_maxt, 0)[row] = maxt;
  cluster.map_shared_rank(S.t_score, 0)[row] = s;
}

// One table row in the serving warp's registers: the node's changing state
// (its capacity stays in the table, row k).
template <int R>
struct Row {
  float idle[R], fut[R];
  int k, nt, maxt;
  float stat, pack;

  __device__ void load(const Smem<R>& S, int K, int row) {
    k = row;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      idle[r] = S.t_idle[r * K + k];
      fut[r] = S.t_fut[r * K + k];
    }
    nt = S.t_nt[k];
    maxt = S.t_maxt[k];
    stat = S.t_static[k];
    pack = S.t_pack[k];
  }

  // fit bits (1 idle, 2 future) against the table's group
  __device__ int fit_bits(const Req<R>& q, const float (&eps)[R],
                          bool allow_pipeline) const {
    const bool ok = (maxt == 0) | (nt < maxt);
    return (ok && q.fits(idle, eps) ? 1 : 0) |
           (ok && allow_pipeline && q.fits(fut, eps) ? 2 : 0);
  }

  __device__ float stat_eff(const Req<R>& q, bool sb) const {
    return stat + (sb ? pack : 0.0f) * q.bonus;
  }

  __device__ void alloc(const Smem<R>& S, int K, float (&out)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = S.t_alloc[r * K + k];
  }
};

template <int R, int B>
__global__ void __launch_bounds__(kThreads, 1) gang_allocate_kernel(Args a) {
  constexpr int K = 2 * kC * B;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int nb = a.nb, T = a.T;
  const int lo = rank * nb;
  const int n_local = max(0, min(nb, a.N - lo));
  const Smem<R> S(smem, a, K);
  const bool leader = rank == 0 && warp == 0;

  float eps[R];
#pragma unroll
  for (int r = 0; r < R; ++r) eps[r] = __ldg(a.eps + r);

  // ---- this block's node state into shared memory; block 0 initialises
  // the outputs and takes the fair-share state
  for (int i = tid; i < n_local; i += kThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      S.idle[r * nb + i] = __ldg(a.node_idle + (size_t)(lo + i) * R + r);
      S.fut[r * nb + i] = __ldg(a.node_future + (size_t)(lo + i) * R + r);
      S.alloc[r * nb + i] = __ldg(a.node_alloc + (size_t)(lo + i) * R + r);
    }
    S.ntasks[i] = __ldg(a.node_ntasks + lo + i);
    S.maxt[i] = __ldg(a.node_max_tasks + lo + i);
    S.pack[i] = 0.0f;
    S.pgen[i] = -1;
  }
  if (rank == 0) {
    for (int t = tid; t < T; t += kThreads) {
      a.assign[t] = -1;
      a.pipelined[t] = 0;
    }
    for (int j = tid; j < a.J; j += kThreads) {
      a.ready[j] = 0;
      a.kept[j] = 0;
    }
    for (int i = tid; i < a.Q * R; i += kThreads) S.q_alloc[i] = a.q_alloc[i];
    for (int i = tid; i < a.NS * R; i += kThreads)
      S.ns_alloc[i] = a.ns_alloc[i];
    for (int p = tid; p < a.P; p += kThreads) S.p_cursor[p] = 0;
  }
  cluster.sync();

  // the serving warp's state, the same in each of its lanes
  int pool = -1, job = -1, t_off = 0, placed = 0, placed_alloc = 0;
  int cur_bucket = -1, step = 0, since = kC, prev_g = -1, prev_b = -1;
  int prev_s = -1, gen = 0, refreshes = 0, t_idx = 0, g = 0, b = -1, slot = -1;
  bool force = true, fresh = false, cached_sb = false, valid = false,
       sb = false;
  // this lane's candidate row: lanes 0..15 the idle class, 16..31 the
  // future class, best first; gidx -1 = none
  int gidx = -1, fit = 0;
  float score = -INFINITY;
  Row<R> mine_row;
  bool dirty = false;   // the row holds the node placed last
  int dirty_src = -1;   // the lane that placed it: its state is the node's
  float placed_res[R];
#pragma unroll
  for (int r = 0; r < R; ++r) placed_res[r] = 0.0f;
  // the current job's span and gang numbers
  int j_start = 0, j_n = 0, j_base = 0, j_min = 0;
  auto take_job = [&]() {
    if (job < 0) return;
    j_start = __ldg(a.job_task_start + job);
    j_n = __ldg(a.job_n_tasks + job);
    j_base = __ldg(a.job_ready_base + job);
    j_min = __ldg(a.job_min_available + job);
  };
  if (leader) {
    pool = select_pool<R>(a, S, eps, &job, lane);
    take_job();
  }

  for (;;) {
    if (leader) {
      // ---- serve steps from the table until one needs a refresh
      for (;;) {
        if (fresh) {
          fresh = false;
          since = 1;
          force = false;
          refreshes += 1;
          cached_sb = sb;
          dirty = false;
          dirty_src = -1;
          const int row = S.m_i[lane];   // list 0: [class][kC] = lane
          gidx = row != kNone ? S.t_gidx[row] : -1;
          fit = row != kNone ? S.t_fit[row] : 0;
          score = S.m_s[lane];
          if (row != kNone) mine_row.load(S, K, row);
        } else {
          int kind = -1;
          if (job < 0 || step >= T) {
            kind = kDone;
          } else {
            t_idx = min(max(j_start + t_off, 0), T - 1);
            g = __ldg(a.task_group + t_idx);
            b = __ldg(a.task_bucket + t_idx);
            slot = a.task_slot != nullptr ? __ldg(a.task_slot + t_idx) : -1;
            valid = __ldg(a.task_valid + t_idx) && t_off < j_n;
            sb = b >= 0 && b == cur_bucket;
            if (!sb) gen += 1;   // the pack row starts over
            const bool need = force || since >= kC || g != prev_g ||
                              b != prev_b || slot != prev_s;
            prev_g = g;
            prev_b = b;
            prev_s = slot;
            if (!valid) force = need;
            else if (need) kind = kRefresh;
            else since += 1;
          }
          if (kind >= 0) {
            if (lane < B) {
              int* d = cluster.map_shared_rank(S.desc, lane);
              d[0] = kind;
              d[1] = g;
              d[2] = sb;
              d[3] = gen;
              d[4] = slot;
            }
            break;
          }
        }

        if (valid) {
          // g is the table's group: a group change refreshes
          const Req<R>& q = *S.q;
          if (sb != cached_sb) {
            // every row's pack term changes
            cached_sb = sb;
            if (gidx >= 0) {
              float alloc[R];
              mine_row.alloc(S, K, alloc);
              fit = mine_row.fit_bits(q, eps, a.allow_pipeline);
              score = q.score_of(mine_row.idle, alloc,
                                 mine_row.stat_eff(q, sb));
            }
          } else if (dirty_src >= 0) {
            // the rows of the node placed last: the warp scores it once
            float alloc[R];
            if (lane == dirty_src) mine_row.alloc(S, K, alloc);
            const int f = __shfl_sync(
                kFull, mine_row.fit_bits(q, eps, a.allow_pipeline), dirty_src);
            const float sc = q.score_of_warp(mine_row.idle, alloc,
                                             mine_row.stat_eff(q, sb),
                                             dirty_src, lane);
            if (dirty) {
              fit = f;
              score = sc;
            }
          }
          dirty = false;
          dirty_src = -1;
          float bi_s = -INFINITY, bf_s = -INFINITY;
          int bi_i = kNone, bf_i = kNone;
          if (fit & 1) {
            bi_s = score;
            bi_i = gidx;
          }
          if (fit & 2) {
            bf_s = score;
            bf_i = gidx;
          }
          warp_argmax(bi_s, bi_i);
          warp_argmax(bf_s, bf_i);
          const bool any_idle = bi_i != kNone;
          const int sel = any_idle ? bi_i : bf_i;
          if (sel != kNone) {
            const bool pipe = !any_idle;
            const bool mine = gidx == sel;   // at most one row a class
            const int writer = __ffs(__ballot_sync(kFull, mine)) - 1;
            Row<R>& x = mine_row;
            if (lane == writer) {
              float* e = a.undo + (size_t)placed * (2 + 2 * R);
              e[0] = __int_as_float(sel);
              e[1] = __int_as_float(x.nt);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                e[2 + r] = x.idle[r];
                e[2 + R + r] = x.fut[r];
              }
            }
            if (mine) {
#pragma unroll
              for (int r = 0; r < R; ++r) {
                if (!pipe) x.idle[r] = x.idle[r] - q.req[r];
                x.fut[r] = x.fut[r] - q.req[r];
              }
              x.nt += 1;
              x.pack = x.pack + 1.0f;
            }
            dirty = mine;
            dirty_src = writer;
            if (lane == writer) {
              // the node's new state into its owner block
              // block b's rows are b*32 .. b*32+31
              const int owner = x.k / (2 * kC), loc = sel - owner * nb;
              float* o_idle = cluster.map_shared_rank(S.idle, owner);
              float* o_fut = cluster.map_shared_rank(S.fut, owner);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                o_idle[r * nb + loc] = x.idle[r];
                o_fut[r * nb + loc] = x.fut[r];
              }
              cluster.map_shared_rank(S.ntasks, owner)[loc] = x.nt;
              cluster.map_shared_rank(S.pack, owner)[loc] = sb ? x.pack : 1.0f;
              cluster.map_shared_rank(S.pgen, owner)[loc] = gen;
            }
            if (lane == 0) {
              a.assign[t_idx] = sel;
              a.pipelined[t_idx] = pipe;
            }
            placed += 1;
            placed_alloc += pipe ? 0 : 1;
#pragma unroll
            for (int r = 0; r < R; ++r)
              placed_res[r] = placed_res[r] + q.req[r];
            __syncwarp();
          }
          cur_bucket = b;
        }
        t_off += 1;
        step += 1;

        // ---- job boundary: gang commit or rollback, charges, next job
        if (t_off >= j_n) {
          const bool is_ready = j_base + placed_alloc >= j_min;
          const bool is_kept = j_base + placed >= j_min;
          const bool roll = !(is_ready || is_kept);
          if (lane == 0) {
            if (roll) {
              // replay the undo log backwards into the owner blocks
              for (int e = placed - 1; e >= 0; --e) {
                const float* u = a.undo + (size_t)e * (2 + 2 * R);
                const int node = __float_as_int(u[0]);
                const int owner = node / nb, loc = node - owner * nb;
                float* o_idle = cluster.map_shared_rank(S.idle, owner);
                float* o_fut = cluster.map_shared_rank(S.fut, owner);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                  o_idle[r * nb + loc] = u[2 + r];
                  o_fut[r * nb + loc] = u[2 + R + r];
                }
                cluster.map_shared_rank(S.ntasks, owner)[loc] =
                    __float_as_int(u[1]);
              }
            } else {
              const int qi = __ldg(a.pool_queue + pool);
              const int ns = __ldg(a.pool_ns + pool);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                S.q_alloc[qi * R + r] = S.q_alloc[qi * R + r] + placed_res[r];
                S.ns_alloc[ns * R + r] = S.ns_alloc[ns * R + r] + placed_res[r];
              }
            }
            S.p_cursor[pool] += 1;
            if (is_ready) a.ready[job] = 1;
            if (is_kept) a.kept[job] = 1;
          }
          __syncwarp();
          if (roll) force = true;
          pool = select_pool<R>(a, S, eps, &job, lane);
          take_job();
          t_off = placed = placed_alloc = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) placed_res[r] = 0.0f;
        }
      }
    }
    cluster.sync();
    if (S.desc[0] == kDone) break;
    refresh<R, B>(a, S, cluster, eps, rank, lo, n_local);
    cluster.sync();
    if (rank == 0) merge_blocks<R, B>(S, tid, warp, lane);
    if (leader) fresh = true;
  }

  // ---- the final node and fair-share state; tasks of jobs neither
  // committed nor kept are not placed
  for (int i = tid; i < n_local; i += kThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a.out_idle[(size_t)(lo + i) * R + r] = S.idle[r * nb + i];
      a.out_future[(size_t)(lo + i) * R + r] = S.fut[r * nb + i];
    }
    a.out_ntasks[lo + i] = S.ntasks[i];
  }
  if (rank != 0) return;
  if (leader && lane == 0) {
    unsigned dyn_smem;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_smem));
    a.stats[0] = refreshes;
    a.stats[1] = (int)cluster.num_blocks();
    a.stats[2] = (int)dyn_smem;
  }
  for (int i = tid; i < a.Q * R; i += kThreads) a.q_alloc[i] = S.q_alloc[i];
  for (int i = tid; i < a.NS * R; i += kThreads) a.ns_alloc[i] = S.ns_alloc[i];
  for (int p = tid; p < a.P; p += kThreads) a.p_cursor[p] = S.p_cursor[p];
  __syncthreads();
  for (int t = tid; t < T; t += kThreads) {
    int j = min(max(a.task_job[t], 0), a.J - 1);
    if (!(a.task_valid[t] && (a.ready[j] || a.kept[j]))) {
      a.assign[t] = -1;
      a.pipelined[t] = 0;
    }
  }
}

template <int R, int B>
cudaError_t launch(const Args& a, int shared_bytes, cudaStream_t stream) {
  auto kernel = gang_allocate_kernel<R, B>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (e != cudaSuccess) return e;
  if (B > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidClusterSize;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const Args& a, int blocks, int shared_bytes,
                     cudaStream_t stream) {
  return blocks == 8 ? launch<R, 8>(a, shared_bytes, stream)
                     : launch<R, 16>(a, shared_bytes, stream);
}

}  // namespace

extern "C" {

// Launches the kernel as one cluster of `blocks` blocks on `stream`
// without synchronising. Returns the cudaError_t of the launch (0 on
// success): cudaErrorInvalidValue (1) for a resource count outside 2..8,
// a cluster size other than 8 or 16, a task_slot without slot_ok rows, or
// a shared-memory size that is not this file's layout (task_slot null
// means no domain slots, else slot_ok holds S + 1 rows of N bytes);
// cudaErrorInvalidClusterSize
// when the card cannot host the cluster.
int gang_allocate_launch(
    const void* task_group, const void* task_valid, const void* task_bucket,
    const void* task_job, const void* task_slot, const void* slot_ok,
    const void* group_req, const void* group_mask,
    const void* group_static, const void* group_pack_bonus,
    const void* job_min_available, const void* job_ready_base,
    const void* job_task_start, const void* job_n_tasks,
    const void* pool_queue, const void* pool_ns, const void* pool_job_start,
    const void* pool_njobs, const void* ns_weight, const void* ns_total,
    const void* queue_deserved, const void* node_idle,
    const void* node_future, const void* node_alloc, const void* node_ntasks,
    const void* node_max_tasks, const void* eps, const void* weights,
    void* out_idle, void* out_future, void* out_ntasks, void* undo,
    void* q_alloc, void* ns_alloc, void* p_cursor, void* assign,
    void* pipelined, void* ready, void* kept, void* stats,
    int T, int J, int P, int NS, int Q, int N, int S, int R,
    int allow_pipeline,
    int ns_live, int blocks, int nodes_per_block, int shared_bytes,
    void* stream) {
  if (R < 2 || R > 8 || (blocks != 8 && blocks != 16) ||
      (task_slot != nullptr && (slot_ok == nullptr || S < 0)) ||
      nodes_per_block < 1 || (long)blocks * nodes_per_block < N ||
      shared_bytes !=
          4 * shared_words(nodes_per_block, blocks, R, Q, NS, P))
    return cudaErrorInvalidValue;
  Args a;
  a.task_group = static_cast<const int32_t*>(task_group);
  a.task_valid = static_cast<const uint8_t*>(task_valid);
  a.task_bucket = static_cast<const int32_t*>(task_bucket);
  a.task_job = static_cast<const int32_t*>(task_job);
  a.task_slot = static_cast<const int32_t*>(task_slot);
  a.slot_ok = static_cast<const uint8_t*>(slot_ok);
  a.group_req = static_cast<const float*>(group_req);
  a.group_mask = static_cast<const uint8_t*>(group_mask);
  a.group_static = static_cast<const float*>(group_static);
  a.group_pack_bonus = static_cast<const float*>(group_pack_bonus);
  a.job_min_available = static_cast<const int32_t*>(job_min_available);
  a.job_ready_base = static_cast<const int32_t*>(job_ready_base);
  a.job_task_start = static_cast<const int32_t*>(job_task_start);
  a.job_n_tasks = static_cast<const int32_t*>(job_n_tasks);
  a.pool_queue = static_cast<const int32_t*>(pool_queue);
  a.pool_ns = static_cast<const int32_t*>(pool_ns);
  a.pool_job_start = static_cast<const int32_t*>(pool_job_start);
  a.pool_njobs = static_cast<const int32_t*>(pool_njobs);
  a.ns_weight = static_cast<const float*>(ns_weight);
  a.ns_total = static_cast<const float*>(ns_total);
  a.queue_deserved = static_cast<const float*>(queue_deserved);
  a.node_idle = static_cast<const float*>(node_idle);
  a.node_future = static_cast<const float*>(node_future);
  a.node_alloc = static_cast<const float*>(node_alloc);
  a.node_ntasks = static_cast<const int32_t*>(node_ntasks);
  a.node_max_tasks = static_cast<const int32_t*>(node_max_tasks);
  a.eps = static_cast<const float*>(eps);
  a.weights = static_cast<const float*>(weights);
  a.out_idle = static_cast<float*>(out_idle);
  a.out_future = static_cast<float*>(out_future);
  a.out_ntasks = static_cast<int32_t*>(out_ntasks);
  a.undo = static_cast<float*>(undo);
  a.q_alloc = static_cast<float*>(q_alloc);
  a.ns_alloc = static_cast<float*>(ns_alloc);
  a.p_cursor = static_cast<int32_t*>(p_cursor);
  a.assign = static_cast<int32_t*>(assign);
  a.pipelined = static_cast<uint8_t*>(pipelined);
  a.ready = static_cast<uint8_t*>(ready);
  a.kept = static_cast<uint8_t*>(kept);
  a.stats = static_cast<int32_t*>(stats);
  a.T = T;
  a.J = J;
  a.P = P;
  a.NS = NS;
  a.Q = Q;
  a.N = N;
  a.S = S;
  a.allow_pipeline = allow_pipeline;
  a.ns_live = ns_live;
  a.nb = nodes_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: return launch_r<2>(a, blocks, shared_bytes, s);
    case 3: return launch_r<3>(a, blocks, shared_bytes, s);
    case 4: return launch_r<4>(a, blocks, shared_bytes, s);
    case 5: return launch_r<5>(a, blocks, shared_bytes, s);
    case 6: return launch_r<6>(a, blocks, shared_bytes, s);
    case 7: return launch_r<7>(a, blocks, shared_bytes, s);
    default: return launch_r<8>(a, blocks, shared_bytes, s);
  }
}

const char* gang_allocate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
