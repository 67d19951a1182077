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
// once per placement; the task axis is a loop inside it. Block b owns the
// contiguous node range [b*nb, (b+1)*nb); block 0 also keeps the
// fair-share state (queue and namespace allocations, pool cursors). The
// wrapper (ops/cuda_allocate.py:cluster_plan) picks one of two plans by
// shape before the launch:
//
//   shared: each block keeps its nodes' state (idle, future, alloc, pod
//     count and cap, pack row and its generation) in its shared memory for
//     the whole launch; B is 8 while a block holds at most 512 nodes, else
//     16. Taken wherever the state fits the 227 KB a block may use.
//   global: the same per-block layout lives in a scratch buffer in device
//     memory (G = true), with B = 16. At (3R + 4) x 4 bytes a node it stays
//     resident in the 50 MB L2 up to hundreds of thousands of nodes, so a
//     refresh reads L2. The candidate table, the warps' lists, the step
//     descriptor and the group request stay in shared memory; the
//     fair-share state moves to device memory too when it alone would not
//     fit. A served step writes the placed node's new state to its owner's
//     rows in device memory instead of over distributed shared memory; the
//     cluster barrier (barrier.cluster.arrive.release / wait.acquire)
//     orders those stores, and the rollback's, before the next refresh.
//
// The resource count R: R = 2..16 are compiled exactly (no padded
// resource, whose fits and binpack terms would enter every score), the
// node and table rows held in registers. Above 16 the kernel runs a form
// where R is a runtime loop bound (template R = 0): a lane reads its node
// and table rows from memory through strided views instead of holding
// them in registers, the group's request is read from device memory, a
// served step's divisions take ceil((R + 6) / 32) rounds of the warp, and
// the running request sum of the job lives in device memory; the table's
// R-wide rows move to device memory when they would not fit shared
// memory. So no R >= 2 is refused.
//
// The build compiles this file in four parts in parallel (the nvcc-parts
// line below; ops/build.py), each part the kernels of a quarter of the R
// values, and links them into one library.
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
// blocks (their shared memory, or their rows in device memory under the
// global plan), and the next step refreshes. A commit costs nothing. The pack
// row is reset by bumping a generation number: a node's pack counts only
// when its generation is the current one.
//
// What bounds it on an H100: the steps are strictly dependent. A served
// step is a chain of latencies in one warp (the task's loads, one node's
// score, the shuffle argmax, the placement's stores, the job boundary's
// loads); a refresh is a sweep of nb nodes (about 80 float operations
// each, ten IEEE divisions) on each of B SMs, the top-kC merges and two
// cluster barriers. The card-wide floors (each input read once over HBM,
// the operations over the float32 peak) are far below both. Under the
// global plan a refresh's node reads come from L2 rather than shared
// memory.
//
// Floating point: build with -fmad=false. Every score, in the sweep and in
// a served step, is computed in the operation order of ops/score.py:
// node_score (score_of, and score_of_warp, which only moves its divisions
// to other lanes), one rounding per operation, so that the kernel and the
// plain PyTorch version round alike on the card and break argmax ties
// alike.


// nvcc-parts: 4

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// PART of PARTS: this compile instantiates the kernels of the R values
// owner_part gives it; part 0 also holds the C entry point. A build that
// does not split the file compiles everything in one part.
#ifndef PART
#define PART 0
#define PARTS 1
#endif

namespace cg = cooperative_groups;

namespace ga {

constexpr int kC = 16;          // candidates a block keeps per fit class
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;  // node index of "no candidate"
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDescWords = 5;  // kind, group, same bucket, pack generation, slot
constexpr int kMaxStaticR = 16;  // R = 2..16 compiled; above, the runtime form
constexpr int kRefresh = 0, kDone = 1;
// the plan's flags: node state, fair-share state, the table's R-wide rows
// in device memory
constexpr int kNodeGlobal = 1;
constexpr int kFairGlobal = 2;
constexpr int kRowsGlobal = 4;

static_assert(2 * kC == 32, "a block's table rows are one warp's lanes");

// shared words of the group request: a Req<R> (at least the R = 8 size),
// or the runtime form's Req<0> with room to align its pointers
__host__ __device__ constexpr int req_words(int R) {
  return R > kMaxStaticR ? 16 : 2 * (R < 8 ? 8 : R) + 6;
}

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
  // device-memory scratch of the plan: the blocks' node state (global
  // plan, block_words a block), the table's R-wide rows (kRowsGlobal) and
  // the job's running request sum (the runtime form)
  float* nstate;
  float* trows;
  float* pres;
  size_t block_words;
  int T, J, P, NS, Q, N, S, R;
  int allow_pipeline, ns_live;
  int nb;                         // nodes a block owns
  int flags;                      // kNodeGlobal | kFairGlobal | kRowsGlobal
};

// The request of one group and the score weights it takes; R = 0 is the
// runtime form, which reads the request from device memory.
template <int R>
struct Req {
  static_assert(2 * R + 6 <= req_words(R), "Req must fit its shared words");
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
  __device__ int n() const { return R; }
  __device__ float rq(int r) const { return req[r]; }
  __device__ float wt(int r) const { return w[r]; }
};

template <>
struct Req<0> {
  const float* req_row;
  const float* w_res;
  int nr;
  float wsum, bonus;
  float w_binpack, w_least, w_most, w_balanced;

  __device__ Req(const Args& a, int g)
      : req_row(a.group_req + (size_t)g * a.R), w_res(a.weights + 4),
        nr(a.R) {
    for (int r = 0; r < nr; ++r) wsum = (r == 0) ? wt(r) : wsum + wt(r);
    wsum = fmaxf(wsum, 1e-9f);
    bonus = __ldg(a.group_pack_bonus + g);
    w_binpack = __ldg(a.weights + 0);
    w_least = __ldg(a.weights + 1);
    w_most = __ldg(a.weights + 2);
    w_balanced = __ldg(a.weights + 3);
  }
  __device__ int n() const { return nr; }
  __device__ float rq(int r) const { return __ldg(req_row + r); }
  __device__ float wt(int r) const {
    const float wr = __ldg(w_res + r);
    return (rq(r) > 0.0f && wr > 0.0f) ? wr : 0.0f;
  }
};

static_assert(sizeof(Req<0>) + 4 <= 4 * req_words(kMaxStaticR + 1),
              "Req<0> must fit its shared words once aligned");

// An R-vector: registers at a compiled R, a strided view of shared or
// device memory in the runtime form.
template <int R>
struct Regs {
  float v[R];
  __device__ float& operator[](int r) { return v[r]; }
  __device__ const float& operator[](int r) const { return v[r]; }
};

struct View {
  float* p;
  int s;
  __device__ float& operator[](int r) const { return p[(size_t)r * s]; }
};

template <int R>
using Vec =
    typename std::conditional<(R > 0), Regs<(R > 0 ? R : 1)>, View>::type;

// fits: req <= cap + eps in every resource
template <class Q, class V, class E>
__device__ __forceinline__ bool fits(const Q& q, const V& cap, const E& eps) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < q.n(); ++r) ok &= q.rq(r) <= cap[r] + eps[r];
  return ok;
}

// ops/score.py:node_score, operation for operation; stat_eff is the
// static score plus pack * bonus
template <class Q, class V1, class V2>
__device__ __forceinline__ float score_of(const Q& q, const V1& idle,
                                          const V2& alloc, float stat_eff) {
  float num = 0.0f;
#pragma unroll
  for (int r = 0; r < q.n(); ++r) {
    const float al = alloc[r];
    const float used = al - idle[r];
    float frac = al > 0.0f ? (used + q.rq(r)) / fmaxf(al, 1e-9f) : 2.0f;
    float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
    num = (r == 0) ? per * q.wt(r) : num + per * q.wt(r);
  }
  float lr[2], mr[2], fr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float al = alloc[r];
    float u = (al - idle[r]) + q.rq(r);
    float den = fmaxf(al, 1e-9f);
    lr[r] = (al > 0.0f ? fmaxf(al - u, 0.0f) / den : 0.0f) * 100.0f;
    mr[r] = (al > 0.0f ? fminf(fmaxf(u, 0.0f), al) / den : 0.0f) * 100.0f;
    fr[r] = al > 0.0f ? u / den : 0.0f;
  }
  float s = q.w_binpack * (num / q.wsum);
  s = s + q.w_least * ((lr[0] + lr[1]) / 2.0f);
  s = s + q.w_most * ((mr[0] + mr[1]) / 2.0f);
  s = s + q.w_balanced * (100.0f - fabsf(fr[0] - fr[1]) * 100.0f);
  return s + stat_eff;
}

// Dynamic shared memory of a block, in 4-byte words, for the plan's flags
// as 0/1 (node_g, fs_g, rows_g) and req = req_words(R);
// ops/cuda_allocate.py:shared_bytes computes the same size.
__host__ __device__ inline long shared_words(long nb, long blocks, long R,
                                             long Q, long NS, long P,
                                             long node_g, long fs_g,
                                             long rows_g, long req) {
  return (1 - node_g) * (3 * R + 4) * nb +
         (3 * R * (1 - rows_g) + 7) * 2 * kC * blocks +
         kWarps * 2 * kC * 2 + kDescWords + req +
         (1 - fs_g) * ((Q + NS) * R + P);
}

template <int R>
struct Smem {
  // this block's nodes: [R][nb] and [nb], in shared memory or (global
  // plan) in the block's rows of device memory
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

  __device__ Smem(float* f, const Args& a, int K, int rank, bool node_g) {
    const int nb = a.nb;
    const int nr = R > 0 ? R : a.R;
    const bool fs_g = node_g && (a.flags & kFairGlobal);
    const bool rows_g = R == 0 && (a.flags & kRowsGlobal);
    float* n = node_g ? a.nstate + (size_t)rank * a.block_words : f;
    idle = n; n += nr * nb;
    fut = n; n += nr * nb;
    alloc = n; n += nr * nb;
    ntasks = reinterpret_cast<int*>(n); n += nb;
    maxt = reinterpret_cast<int*>(n); n += nb;
    pack = n; n += nb;
    pgen = reinterpret_cast<int*>(n); n += nb;
    if (!node_g) f = n;
    t_gidx = reinterpret_cast<int*>(f); f += K;
    t_static = f; f += K;
    t_pack = f; f += K;
    t_nt = reinterpret_cast<int*>(f); f += K;
    t_maxt = reinterpret_cast<int*>(f); f += K;
    if (rows_g) {
      t_idle = a.trows;
      t_fut = a.trows + (size_t)nr * K;
      t_alloc = a.trows + 2 * (size_t)nr * K;
    } else {
      t_idle = f; f += nr * K;
      t_fut = f; f += nr * K;
      t_alloc = f; f += nr * K;
    }
    t_score = f; f += K;
    t_fit = reinterpret_cast<int*>(f); f += K;
    m_s = f; f += kWarps * 2 * kC;
    m_i = reinterpret_cast<int*>(f); f += kWarps * 2 * kC;
    desc = reinterpret_cast<int*>(f); f += kDescWords;
    // Req<0> holds pointers: 8-byte aligned inside its words
    float* qf = f;
    if (R == 0 && (reinterpret_cast<uintptr_t>(qf) & 7)) qf += 1;
    q = reinterpret_cast<Req<R>*>(qf); f += req_words(nr);
    if (fs_g) {
      q_alloc = a.q_alloc;
      ns_alloc = a.ns_alloc;
      p_cursor = a.p_cursor;
    } else {
      q_alloc = f; f += a.Q * nr;
      ns_alloc = f; f += a.NS * nr;
      p_cursor = reinterpret_cast<int*>(f);
    }
  }
};

// Block `owner`'s copy of block 0's node-state array p: its shared memory
// over DSMEM, or its rows in device memory (global plan). Block 0 only.
template <bool G, typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cluster, const Args& a,
                                   T* p, int owner) {
  if constexpr (G)
    return p + (size_t)owner * a.block_words;
  else
    return cluster.map_shared_rank(p, owner);
}

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
__device__ float queue_share(const float* alloc, const float* des, int nr) {
  const int n = R > 0 ? R : nr;
  float m = 0.0f;
#pragma unroll
  for (int r = 0; r < n; ++r) {
    float d = des[r], a = alloc[r];
    float f = isinf(d) ? 0.0f : (d == 0.0f ? (a == 0.0f ? 0.0f : 1.0f) : a / d);
    m = (r == 0) ? f : fmaxf(m, f);
  }
  return m;
}

template <int R>
__device__ bool queue_overused(const float* alloc, const float* des,
                               const float* eps, int nr) {
  const int n = R > 0 ? R : nr;
  bool over = false;
#pragma unroll
  for (int r = 0; r < n; ++r)
    over |= !((alloc[r] <= des[r] + eps[r]) || isinf(des[r]));
  return over;
}

// ops/allocate.make_pool_select: namespace first, then the least-share
// non-overused pool in it; lowest index on ties at both levels. Run by the
// whole serving warp, one pool a lane; every lane gets the result.
template <int R>
__device__ int select_pool(const Args& a, const Smem<R>& S, const float* eps,
                           int* job, int lane) {
  const int nr = R > 0 ? R : a.R;
  auto pool_ok = [&](int p) {
    int q = __ldg(a.pool_queue + p);
    return S.p_cursor[p] < __ldg(a.pool_njobs + p) &&
           !queue_overused<R>(S.q_alloc + q * nr, a.queue_deserved + q * nr,
                              eps, nr);
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
        for (int r = 0; r < nr; ++r) {
          float t = __ldg(a.ns_total + r), al = S.ns_alloc[n * nr + r];
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
      k = queue_share<R>(S.q_alloc + q * nr, a.queue_deserved + q * nr, nr);
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
                        cg::cluster_group& cluster, const Vec<R>& eps,
                        int rank, int lo, int n_local) {
  constexpr int K = 2 * kC * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nb;
  const int nr = R > 0 ? R : a.R;
  const bool rows_g = R == 0 && (a.flags & kRowsGlobal);
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
    const bool ok = real & in_mask & ((maxt == 0) | (nt < maxt));
    bool fi, ff;
    float s;
    if constexpr (R > 0) {
      Regs<R> idle, fut, alloc;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        idle[r] = S.idle[r * nb + lc];
        fut[r] = S.fut[r * nb + lc];
        alloc[r] = S.alloc[r * nb + lc];
      }
      fi = ok & fits(q, idle, eps);
      ff = ok & (a.allow_pipeline != 0) & fits(q, fut, eps);
      s = score_of(q, idle, alloc, stat + pk * q.bonus);
    } else {
      const View idle{S.idle + lc, nb}, fut{S.fut + lc, nb},
          alloc{S.alloc + lc, nb};
      fi = ok & fits(q, idle, eps);
      ff = ok & (a.allow_pipeline != 0) & fits(q, fut, eps);
      s = score_of(q, idle, alloc, stat + pk * q.bonus);
    }
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
  float* t_idle = rows_g ? S.t_idle : cluster.map_shared_rank(S.t_idle, 0);
  float* t_fut = rows_g ? S.t_fut : cluster.map_shared_rank(S.t_fut, 0);
  float* t_alloc =
      rows_g ? S.t_alloc : cluster.map_shared_rank(S.t_alloc, 0);
  bool fi, ff;
  if constexpr (R > 0) {
    Regs<R> idle, fut;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      idle[r] = S.idle[r * nb + li];
      fut[r] = S.fut[r * nb + li];
      t_idle[r * K + row] = idle[r];
      t_fut[r * K + row] = fut[r];
      t_alloc[r * K + row] = S.alloc[r * nb + li];
    }
    fi = fits(q, idle, eps);
    ff = fits(q, fut, eps);
  } else {
    for (int r = 0; r < nr; ++r) {
      t_idle[(size_t)r * K + row] = S.idle[r * nb + li];
      t_fut[(size_t)r * K + row] = S.fut[r * nb + li];
      t_alloc[(size_t)r * K + row] = S.alloc[r * nb + li];
    }
    fi = fits(q, View{S.idle + li, nb}, eps);
    ff = fits(q, View{S.fut + li, nb}, eps);
  }
  // a candidate passed the mask, so its fits hang on the pod cap alone
  const bool ok = (maxt == 0) | (nt < maxt);
  const int fit = (ok && fi ? 1 : 0) | (ok && a.allow_pipeline && ff ? 2 : 0);
  t_gidx[row] = gi;
  t_fit[row] = fit;
  cluster.map_shared_rank(S.t_static, 0)[row] = __ldcg(static_row + gi);
  cluster.map_shared_rank(S.t_pack, 0)[row] =
      (sb && S.pgen[li] == gen) ? S.pack[li] : 0.0f;
  cluster.map_shared_rank(S.t_nt, 0)[row] = nt;
  cluster.map_shared_rank(S.t_maxt, 0)[row] = maxt;
  cluster.map_shared_rank(S.t_score, 0)[row] = s;
}

// One table row in the serving warp: the node's changing state, in
// registers at a compiled R, or the table's own row (a view) in the runtime
// form, where a placement updates it in place. Its capacity stays in the
// table, row k.
template <int R>
struct Row {
  Vec<R> idle, fut;
  int k, nt, maxt;
  float stat, pack;

  __device__ void load(const Smem<R>& S, int K, int row) {
    k = row;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        idle[r] = S.t_idle[r * K + k];
        fut[r] = S.t_fut[r * K + k];
      }
    } else {
      idle = View{S.t_idle + k, K};
      fut = View{S.t_fut + k, K};
    }
    nt = S.t_nt[k];
    maxt = S.t_maxt[k];
    stat = S.t_static[k];
    pack = S.t_pack[k];
  }

  // fit bits (1 idle, 2 future) against the table's group
  template <class E>
  __device__ int fit_bits(const Req<R>& q, const E& eps,
                          bool allow_pipeline) const {
    const bool ok = (maxt == 0) | (nt < maxt);
    return (ok && fits(q, idle, eps) ? 1 : 0) |
           (ok && allow_pipeline && fits(q, fut, eps) ? 2 : 0);
  }

  __device__ float stat_eff(const Req<R>& q, bool sb) const {
    return stat + (sb ? pack : 0.0f) * q.bonus;
  }

  __device__ Vec<R> alloc(const Smem<R>& S, int K) const {
    if constexpr (R > 0) {
      Regs<R> out;
#pragma unroll
      for (int r = 0; r < R; ++r) out[r] = S.t_alloc[r * K + k];
      return out;
    } else {
      return View{S.t_alloc + k, K};
    }
  }
};

// score_of for the node of lane `src`'s row, computed by the whole warp
// (every lane gets it): each of its R + 6 divisions runs on a lane of its
// own (in rounds of 32 in the runtime form), then the terms are summed in
// score_of's order
template <int R>
__device__ float score_of_warp(const Req<R>& q, const Smem<R>& S, int K,
                               const Row<R>& x, float stat_eff_src, int src,
                               int lane) {
  const float stat_eff = __shfl_sync(kFull, stat_eff_src, src);
  float acc = 0.0f;
  float lr[2], mr[2], fr[2];
  if constexpr (R > 0) {
    Regs<R> alloc_src;
    if (lane == src) alloc_src = x.alloc(S, K);
    float idle[R], alloc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      idle[r] = __shfl_sync(kFull, x.idle[r], src);
      alloc[r] = __shfl_sync(kFull, alloc_src[r], src);
    }
    float num = 1.0f, den = 1.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float used = alloc[r] - idle[r];
      const float u = used + q.rq(r);
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
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float qr = __shfl_sync(kFull, quo, r);
      float frac = alloc[r] > 0.0f ? qr : 2.0f;
      float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
      acc = (r == 0) ? per * q.wt(r) : acc + per * q.wt(r);
    }
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
  } else {
    // every lane reads the source row from the table
    const int ks = __shfl_sync(kFull, x.k, src);
    const View idle{S.t_idle + ks, K}, alloc{S.t_alloc + ks, K};
    const int nr = q.n(), nd = nr + 6;
    for (int base = 0; base < nd; base += 32) {
      // division d: d < R binpack's, then least, most and the balanced
      // fraction of resources 0 and 1
      const int d = base + lane;
      float num = 1.0f, den = 1.0f;
      if (d < nr) {
        num = (alloc[d] - idle[d]) + q.rq(d);
        den = fmaxf(alloc[d], 1e-9f);
      } else if (d < nd) {
        const int j = d - nr, r = j & 1, kind = j >> 1;
        const float al = alloc[r];
        const float u = (al - idle[r]) + q.rq(r);
        den = fmaxf(al, 1e-9f);
        num = kind == 0 ? fmaxf(al - u, 0.0f)
                        : (kind == 1 ? fminf(fmaxf(u, 0.0f), al) : u);
      }
      const float quo = num / den;
      const int top = min(base + 32, nr);
      for (int r = base; r < top; ++r) {
        const float qr = __shfl_sync(kFull, quo, r - base);
        float frac = alloc[r] > 0.0f ? qr : 2.0f;
        float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
        acc = (r == 0) ? per * q.wt(r) : acc + per * q.wt(r);
      }
      for (int j = 0; j < 6; ++j) {
        const int dj = nr + j;
        if (dj < base || dj >= base + 32) continue;
        const float v = __shfl_sync(kFull, quo, dj - base);
        const int r = j & 1;
        const bool pos = alloc[r] > 0.0f;
        if (j < 2)
          lr[r] = (pos ? v : 0.0f) * 100.0f;
        else if (j < 4)
          mr[r] = (pos ? v : 0.0f) * 100.0f;
        else
          fr[r] = pos ? v : 0.0f;
      }
    }
  }
  float s = q.w_binpack * (acc / q.wsum);
  s = s + q.w_least * ((lr[0] + lr[1]) / 2.0f);
  s = s + q.w_most * ((mr[0] + mr[1]) / 2.0f);
  s = s + q.w_balanced * (100.0f - fabsf(fr[0] - fr[1]) * 100.0f);
  return s + stat_eff;
}

template <int R, int B, bool G>
__global__ void __launch_bounds__(kThreads, 1) gang_allocate_kernel(Args a) {
  constexpr int K = 2 * kC * B;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int nb = a.nb, T = a.T;
  const int nr = R > 0 ? R : a.R;
  const int lo = rank * nb;
  const int n_local = max(0, min(nb, a.N - lo));
  const Smem<R> S(smem, a, K, rank, G);
  const bool fs_g = G && (a.flags & kFairGlobal);
  const bool leader = rank == 0 && warp == 0;

  Vec<R> eps;
  if constexpr (R > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) eps[r] = __ldg(a.eps + r);
  } else {
    eps = View{const_cast<float*>(a.eps), 1};
  }

  // ---- this block's node state into shared memory (or its rows of
  // device memory); block 0 initialises the outputs and takes the
  // fair-share state
  for (int i = tid; i < n_local; i += kThreads) {
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      S.idle[r * nb + i] = __ldg(a.node_idle + (size_t)(lo + i) * nr + r);
      S.fut[r * nb + i] = __ldg(a.node_future + (size_t)(lo + i) * nr + r);
      S.alloc[r * nb + i] = __ldg(a.node_alloc + (size_t)(lo + i) * nr + r);
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
    if (!fs_g) {
      for (int i = tid; i < a.Q * nr; i += kThreads)
        S.q_alloc[i] = a.q_alloc[i];
      for (int i = tid; i < a.NS * nr; i += kThreads)
        S.ns_alloc[i] = a.ns_alloc[i];
    }
    for (int p = tid; p < a.P; p += kThreads) S.p_cursor[p] = 0;
    if (R == 0)
      for (int r = tid; r < nr; r += kThreads) a.pres[r] = 0.0f;
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
  // the runtime form's views must point into the table from the start
  if (R == 0) mine_row.load(S, K, 0);
  bool dirty = false;   // the row holds the node placed last
  int dirty_src = -1;   // the lane that placed it: its state is the node's
  // the job's running request sum: every lane's registers, or (runtime
  // form) device memory that lane 0 keeps
  float placed_res[R > 0 ? R : 1];
#pragma unroll
  for (int r = 0; r < (R > 0 ? R : 1); ++r) placed_res[r] = 0.0f;
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
    pool = select_pool<R>(a, S, &eps[0], &job, lane);
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
              const Vec<R> alloc = mine_row.alloc(S, K);
              fit = mine_row.fit_bits(q, eps, a.allow_pipeline);
              score = score_of(q, mine_row.idle, alloc,
                               mine_row.stat_eff(q, sb));
            }
          } else if (dirty_src >= 0) {
            // the rows of the node placed last: the warp scores it once
            const int f = __shfl_sync(
                kFull, mine_row.fit_bits(q, eps, a.allow_pipeline), dirty_src);
            const float sc = score_of_warp<R>(
                q, S, K, mine_row, mine_row.stat_eff(q, sb), dirty_src, lane);
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
              float* e = a.undo + (size_t)placed * (2 + 2 * nr);
              e[0] = __int_as_float(sel);
              e[1] = __int_as_float(x.nt);
#pragma unroll
              for (int r = 0; r < nr; ++r) {
                e[2 + r] = x.idle[r];
                e[2 + nr + r] = x.fut[r];
              }
            }
            if (mine) {
#pragma unroll
              for (int r = 0; r < nr; ++r) {
                if (!pipe) x.idle[r] = x.idle[r] - q.rq(r);
                x.fut[r] = x.fut[r] - q.rq(r);
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
              float* o_idle = peer<G>(cluster, a, S.idle, owner);
              float* o_fut = peer<G>(cluster, a, S.fut, owner);
#pragma unroll
              for (int r = 0; r < nr; ++r) {
                o_idle[r * nb + loc] = x.idle[r];
                o_fut[r * nb + loc] = x.fut[r];
              }
              peer<G>(cluster, a, S.ntasks, owner)[loc] = x.nt;
              peer<G>(cluster, a, S.pack, owner)[loc] = sb ? x.pack : 1.0f;
              peer<G>(cluster, a, S.pgen, owner)[loc] = gen;
            }
            if (lane == 0) {
              a.assign[t_idx] = sel;
              a.pipelined[t_idx] = pipe;
            }
            placed += 1;
            placed_alloc += pipe ? 0 : 1;
            if constexpr (R > 0) {
#pragma unroll
              for (int r = 0; r < R; ++r)
                placed_res[r] = placed_res[r] + q.rq(r);
            } else if (lane == 0) {
              for (int r = 0; r < nr; ++r) a.pres[r] = a.pres[r] + q.rq(r);
            }
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
                const float* u = a.undo + (size_t)e * (2 + 2 * nr);
                const int node = __float_as_int(u[0]);
                const int owner = node / nb, loc = node - owner * nb;
                float* o_idle = peer<G>(cluster, a, S.idle, owner);
                float* o_fut = peer<G>(cluster, a, S.fut, owner);
#pragma unroll
                for (int r = 0; r < nr; ++r) {
                  o_idle[r * nb + loc] = u[2 + r];
                  o_fut[r * nb + loc] = u[2 + nr + r];
                }
                peer<G>(cluster, a, S.ntasks, owner)[loc] =
                    __float_as_int(u[1]);
              }
            } else {
              const int qi = __ldg(a.pool_queue + pool);
              const int ns = __ldg(a.pool_ns + pool);
#pragma unroll
              for (int r = 0; r < nr; ++r) {
                float pr;
                if constexpr (R > 0) pr = placed_res[r];
                else pr = a.pres[r];
                S.q_alloc[qi * nr + r] = S.q_alloc[qi * nr + r] + pr;
                S.ns_alloc[ns * nr + r] = S.ns_alloc[ns * nr + r] + pr;
              }
            }
            S.p_cursor[pool] += 1;
            if (is_ready) a.ready[job] = 1;
            if (is_kept) a.kept[job] = 1;
            if (R == 0)
              for (int r = 0; r < nr; ++r) a.pres[r] = 0.0f;
          }
          __syncwarp();
          if (roll) force = true;
          pool = select_pool<R>(a, S, &eps[0], &job, lane);
          take_job();
          t_off = placed = placed_alloc = 0;
#pragma unroll
          for (int r = 0; r < (R > 0 ? R : 1); ++r) placed_res[r] = 0.0f;
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
    for (int r = 0; r < nr; ++r) {
      a.out_idle[(size_t)(lo + i) * nr + r] = S.idle[r * nb + i];
      a.out_future[(size_t)(lo + i) * nr + r] = S.fut[r * nb + i];
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
  if (!fs_g) {
    for (int i = tid; i < a.Q * nr; i += kThreads) a.q_alloc[i] = S.q_alloc[i];
    for (int i = tid; i < a.NS * nr; i += kThreads)
      a.ns_alloc[i] = S.ns_alloc[i];
    for (int p = tid; p < a.P; p += kThreads) a.p_cursor[p] = S.p_cursor[p];
  }
  __syncthreads();
  for (int t = tid; t < T; t += kThreads) {
    int j = min(max(a.task_job[t], 0), a.J - 1);
    if (!(a.task_valid[t] && (a.ready[j] || a.kept[j]))) {
      a.assign[t] = -1;
      a.pipelined[t] = 0;
    }
  }
}

template <int R, int B, bool G>
cudaError_t launch(const Args& a, int shared_bytes, cudaStream_t stream) {
  auto kernel = gang_allocate_kernel<R, B, G>;
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

// the global plan runs 16 blocks; the shared plan 8 or 16
template <int R>
cudaError_t launch_r(const Args& a, int blocks, int shared_bytes,
                     cudaStream_t stream) {
  if (a.flags & kNodeGlobal) return launch<R, 16, true>(a, shared_bytes, stream);
  return blocks == 8 ? launch<R, 8, false>(a, shared_bytes, stream)
                     : launch<R, 16, false>(a, shared_bytes, stream);
}

// the part that compiles the kernels of resource count R (R = 0: the
// runtime form); the sixteen forms are dealt round the parts
__host__ __device__ constexpr int owner_part(int R) {
  return ((R == 0 || R > kMaxStaticR ? kMaxStaticR + 1 : R) - 2) % PARTS;
}

template <int P>
cudaError_t launch_part(const Args& a, int blocks, int shared_bytes,
                        cudaStream_t stream);

template <int R>
cudaError_t launch_owned(const Args& a, int blocks, int shared_bytes,
                         cudaStream_t stream) {
  if constexpr (owner_part(R) == PART)
    return launch_r<R>(a, blocks, shared_bytes, stream);
  else
    return cudaErrorInvalidValue;
}

template <>
cudaError_t launch_part<PART>(const Args& a, int blocks, int shared_bytes,
                              cudaStream_t s) {
  switch (a.R) {
    case 2: return launch_owned<2>(a, blocks, shared_bytes, s);
    case 3: return launch_owned<3>(a, blocks, shared_bytes, s);
    case 4: return launch_owned<4>(a, blocks, shared_bytes, s);
    case 5: return launch_owned<5>(a, blocks, shared_bytes, s);
    case 6: return launch_owned<6>(a, blocks, shared_bytes, s);
    case 7: return launch_owned<7>(a, blocks, shared_bytes, s);
    case 8: return launch_owned<8>(a, blocks, shared_bytes, s);
    case 9: return launch_owned<9>(a, blocks, shared_bytes, s);
    case 10: return launch_owned<10>(a, blocks, shared_bytes, s);
    case 11: return launch_owned<11>(a, blocks, shared_bytes, s);
    case 12: return launch_owned<12>(a, blocks, shared_bytes, s);
    case 13: return launch_owned<13>(a, blocks, shared_bytes, s);
    case 14: return launch_owned<14>(a, blocks, shared_bytes, s);
    case 15: return launch_owned<15>(a, blocks, shared_bytes, s);
    case 16: return launch_owned<16>(a, blocks, shared_bytes, s);
    default: return launch_owned<0>(a, blocks, shared_bytes, s);
  }
}

#if PART == 0
// the other parts' launchers, defined in their own compiles
#if PARTS > 1
template <>
cudaError_t launch_part<1>(const Args&, int, int, cudaStream_t);
#endif
#if PARTS > 2
template <>
cudaError_t launch_part<2>(const Args&, int, int, cudaStream_t);
#endif
#if PARTS > 3
template <>
cudaError_t launch_part<3>(const Args&, int, int, cudaStream_t);
#endif
#endif

}  // namespace ga

#if PART == 0
extern "C" {

// Launches the kernel as one cluster of `blocks` blocks on `stream`
// without synchronising. `flags` is the plan (kNodeGlobal: node state in
// `scratch`, which then needs 16 blocks; kFairGlobal: the fair-share state
// in q_alloc, ns_alloc and p_cursor, with kNodeGlobal only; kRowsGlobal:
// the table's R-wide rows in `scratch`, above R = 16 only), laid out in
// `scratch` as node state, table rows, then R words of the runtime form's
// request sum. Returns the cudaError_t of the launch (0 on success):
// cudaErrorInvalidValue (1) for R < 2, a cluster size other than 8 or 16,
// flags outside these rules, a task_slot without slot_ok rows, a missing
// scratch, or a shared-memory size that is not this file's layout
// (task_slot null means no domain slots, else slot_ok holds S + 1 rows of
// N bytes); cudaErrorInvalidClusterSize when the card cannot host the
// cluster.
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
    void* pipelined, void* ready, void* kept, void* stats, void* scratch,
    int T, int J, int P, int NS, int Q, int N, int S, int R,
    int allow_pipeline,
    int ns_live, int blocks, int nodes_per_block, int flags,
    int shared_bytes, void* stream) {
  using namespace ga;
  const int node_g = (flags & kNodeGlobal) ? 1 : 0;
  const int fs_g = (flags & kFairGlobal) ? 1 : 0;
  const int rows_g = (flags & kRowsGlobal) ? 1 : 0;
  const bool needs_scratch = node_g || rows_g || R > kMaxStaticR;
  if (R < 2 || (blocks != 8 && blocks != 16) || (flags & ~7) ||
      (node_g && blocks != 16) || (fs_g && !node_g) ||
      (rows_g && R <= kMaxStaticR) || (needs_scratch && scratch == nullptr) ||
      (task_slot != nullptr && (slot_ok == nullptr || S < 0)) ||
      nodes_per_block < 1 || (long)blocks * nodes_per_block < N ||
      (long)shared_bytes !=
          4 * shared_words(nodes_per_block, blocks, R, Q, NS, P, node_g,
                           fs_g, rows_g, req_words(R)))
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
  a.block_words = (size_t)(3 * R + 4) * nodes_per_block;
  float* s = static_cast<float*>(scratch);
  a.nstate = s;
  if (node_g) s += (size_t)blocks * a.block_words;
  a.trows = s;
  if (rows_g) s += (size_t)3 * R * 2 * kC * blocks;
  a.pres = s;
  a.T = T;
  a.J = J;
  a.P = P;
  a.NS = NS;
  a.Q = Q;
  a.N = N;
  a.S = S;
  a.R = R;
  a.allow_pipeline = allow_pipeline;
  a.ns_live = ns_live;
  a.nb = nodes_per_block;
  a.flags = flags;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (owner_part(R)) {
#if PARTS > 1
    case 1: return launch_part<1>(a, blocks, shared_bytes, st);
#endif
#if PARTS > 2
    case 2: return launch_part<2>(a, blocks, shared_bytes, st);
#endif
#if PARTS > 3
    case 3: return launch_part<3>(a, blocks, shared_bytes, st);
#endif
    default: return launch_part<0>(a, blocks, shared_bytes, st);
  }
}

const char* gang_allocate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif
