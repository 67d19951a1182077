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
//   ready/kept decision, the rollback to the checkpoint when the gang
//   fails, the queue and namespace charge, and the next (namespace, queue)
//   pool's job.
//
// Design: ONE persistent block of 1024 threads, launched once per
// placement; the task axis is a loop inside the block. Node state lives in
// device memory laid out resource-major ([R, N]), which L2 holds at the
// sizes served (idle, future and their checkpoints are 4 * R * N * 4 bytes,
// 0.66 MB at R = 4, N = 10,240). Thread `tid` owns nodes i = tid (mod 1024)
// for the per-step sweep; a warp-shuffle argmax and one across the warps
// of warp 0 pick the winner. All scalar work (pool selection, gang check,
// charges, cursors) stays with thread 0 between two __syncthreads() a
// step; it publishes the next step's descriptor in shared memory. A rollback
// or commit touches only the nodes the job placed on, found through the
// job's task span in `assign`.
//
// What bounds it on an H100: the steps are strictly dependent, and each
// step's sweep runs on one SM. Per node it reads about 16 words (idle,
// future and alloc at R = 4, the static score and mask, the pod count and
// cap, the pack row: 0.66 MB a step at N = 10,240, which L2 serves) and
// does about 80 float operations, ten of them IEEE divisions. Spread over
// one SM's four schedulers, that instruction stream is estimated to take
// about as long as a step does at N = 10,240, so the sweep is bound by one
// SM's issue rate rather than by memory; the loads of a node are all issued
// before any branch on them so that their latency overlaps. The step's
// fixed cost (two block barriers, the cross-warp reduction and thread 0's
// dependent loads) is small beside the sweep down to 1,024 nodes. The
// card-wide floors (each input read once over HBM, the operations over the
// float32 peak) are far below both.
//
// What the single-block design gives up: it uses 1 of the card's 132 SMs,
// and every step pays the full O(N) sweep. Spreading the node axis over a
// thread-block cluster's distributed shared memory (or over a grid with a
// per-step grid-wide sync), and serving most steps from a top-C candidate
// table (volcano_tpu/ops/sharded.py:_sharded_body_chunked) are later work.
//
// Floating point: build with -fmad=false. The score is written in the
// operation order of ops/score.py:node_score, one rounding per operation,
// so that the kernel and the plain PyTorch version round alike on the card
// and break argmax ties alike.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;  // node index of "no candidate"
constexpr float kBig = 1e30f;

struct Args {
  // task axis [T]
  const int32_t* task_group;
  const uint8_t* task_valid;
  const int32_t* task_bucket;
  const int32_t* task_job;
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
  // nodes
  const float* node_alloc;        // [R, N]
  const int32_t* node_max_tasks;  // [N], 0 = uncapped
  const float* eps;               // [R]
  const float* weights;           // [4 + R]: binpack, least, most, balanced, binpack_res
  // state, updated in place; idle/future/ntasks/q_alloc/ns_alloc hold the
  // initial values on entry, the rest is initialised here
  float* idle;                    // [R, N]
  float* future;                  // [R, N]
  int32_t* ntasks;                // [N]
  float* ck_idle;                 // [R, N]
  float* ck_future;               // [R, N]
  int32_t* ck_ntasks;             // [N]
  float* pack;                    // [N]
  float* q_alloc;                 // [Q, R]
  float* ns_alloc;                // [NS, R]
  int32_t* p_cursor;              // [P]
  // outputs
  int32_t* assign;                // [T]
  uint8_t* pipelined;             // [T]
  uint8_t* ready;                 // [J]
  uint8_t* kept;                  // [J]
  int T, J, P, NS, N;
  int allow_pipeline, ns_live;
};

// The step descriptor thread 0 publishes for every thread.
struct Step {
  int job;          // -1: the loop is over
  int t_idx;
  int g;
  int valid;
  int same_bucket;  // read the pack row (else it counts as zero)
  int reset_pack;   // zero the whole pack row before this step
  int complete;     // the previous step ended a job: fix up its nodes
  int roll;         // ... by restoring them from the checkpoint
  int fix_start;    // task span of that job
  int fix_n;
};

__device__ __forceinline__ void better_of(float& s, int& i, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_down_sync(0xffffffffu, s, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    better_of(s, i, s2, i2);
  }
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
// non-overused pool in it; lowest index on ties at both levels.
template <int R>
__device__ int select_pool(const Args& a, const float* eps, int* job) {
  auto pool_ok = [&](int p) {
    int q = a.pool_queue[p];
    return a.p_cursor[p] < a.pool_njobs[p] &&
           !queue_overused<R>(a.q_alloc + q * R, a.queue_deserved + q * R, eps);
  };
  int ns_sel = 0;
  float best = INFINITY;
  bool sel_has = false;
  for (int n = 0; n < a.NS; ++n) {
    bool has = false;
    for (int p = 0; p < a.P && !has; ++p) has = a.pool_ns[p] == n && pool_ok(p);
    float key = kBig;
    if (has) {
      if (a.ns_live) {
        float m = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float t = a.ns_total[r], al = a.ns_alloc[n * R + r];
          float f = t > 0.0f ? al / t : (al == 0.0f ? 0.0f : 1.0f);
          m = (r == 0) ? f : fmaxf(m, f);
        }
        key = m / a.ns_weight[n];
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
  int p_sel = 0;
  best = INFINITY;
  for (int p = 0; p < a.P; ++p) {
    float key = kBig;
    if (a.pool_ns[p] == ns_sel && pool_ok(p)) {
      int q = a.pool_queue[p];
      key = queue_share<R>(a.q_alloc + q * R, a.queue_deserved + q * R);
    }
    if (key < best) {
      best = key;
      p_sel = p;
    }
  }
  *job = a.pool_job_start[p_sel] + a.p_cursor[p_sel];
  return p_sel;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) gang_allocate_kernel(Args a) {
  __shared__ Step s_step;
  __shared__ float s_ws_idle[kWarps], s_ws_fut[kWarps];
  __shared__ int s_wi_idle[kWarps], s_wi_fut[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = a.N, T = a.T;

  float eps[R], w_res[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    eps[r] = a.eps[r];
    w_res[r] = a.weights[4 + r];
  }
  const float w_binpack = a.weights[0], w_least = a.weights[1];
  const float w_most = a.weights[2], w_balanced = a.weights[3];

  // ---- initialise outputs, checkpoints and scratch
  for (int t = tid; t < T; t += kThreads) {
    a.assign[t] = -1;
    a.pipelined[t] = 0;
  }
  for (int j = tid; j < a.J; j += kThreads) {
    a.ready[j] = 0;
    a.kept[j] = 0;
  }
  for (int p = tid; p < a.P; p += kThreads) a.p_cursor[p] = 0;
  for (int i = tid; i < N; i += kThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a.ck_idle[r * N + i] = a.idle[r * N + i];
      a.ck_future[r * N + i] = a.future[r * N + i];
    }
    a.ck_ntasks[i] = a.ntasks[i];
    a.pack[i] = 0.0f;
  }
  __syncthreads();

  // thread 0's scalar state (lives in its registers across the loop)
  int pool = -1, job = -1, t_off = 0, placed = 0, placed_alloc = 0;
  int cur_bucket = -1, pack_count = 0, pack_last = 0;
  float placed_res[R];
#pragma unroll
  for (int r = 0; r < R; ++r) placed_res[r] = 0.0f;

  // thread 0: the descriptor of the step about to run
  auto publish = [&](int complete, int roll, int fix_start, int fix_n) {
    Step s;
    s.job = job;
    s.complete = complete;
    s.roll = roll;
    s.fix_start = fix_start;
    s.fix_n = fix_n;
    s.reset_pack = 0;
    s.same_bucket = 0;
    s.t_idx = 0;
    s.g = 0;
    s.valid = 0;
    if (job >= 0) {
      int t_idx = min(max(a.job_task_start[job] + t_off, 0), T - 1);
      int b = a.task_bucket[t_idx];
      s.t_idx = t_idx;
      s.g = a.task_group[t_idx];
      s.valid = a.task_valid[t_idx] && t_off < a.job_n_tasks[job];
      s.same_bucket = b >= 0 && b == cur_bucket;
      if (!s.same_bucket && pack_count > 0) {
        // a new bucket starts with no mates: clear the pack row, alone
        // when one node holds it, else with the whole block
        if (pack_count == 1) a.pack[pack_last] = 0.0f;
        else s.reset_pack = 1;
        pack_count = 0;
      }
    }
    s_step = s;
  };

  if (tid == 0) {
    pool = select_pool<R>(a, eps, &job);
    publish(0, 0, 0, 0);
  }
  __syncthreads();

  for (int step = 0;; ++step) {
    const Step st = s_step;
    // ---- fix up the nodes of the job the previous step ended
    if (st.complete) {
      for (int k = tid; k < st.fix_n; k += kThreads) {
        int i = a.assign[st.fix_start + k];
        if (i < 0) continue;
        float* dst_i = st.roll ? a.idle : a.ck_idle;
        const float* src_i = st.roll ? a.ck_idle : a.idle;
        float* dst_f = st.roll ? a.future : a.ck_future;
        const float* src_f = st.roll ? a.ck_future : a.future;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dst_i[r * N + i] = src_i[r * N + i];
          dst_f[r * N + i] = src_f[r * N + i];
        }
        if (st.roll) a.ntasks[i] = a.ck_ntasks[i];
        else a.ck_ntasks[i] = a.ntasks[i];
      }
      __syncthreads();
    }
    if (st.job < 0 || step >= T) break;

    // ---- sweep: fit and score this thread's nodes
    float bi_s = -INFINITY, bf_s = -INFINITY;
    int bi_i = kNone, bf_i = kNone;
    if (st.reset_pack)
      for (int i = tid; i < N; i += kThreads) a.pack[i] = 0.0f;
    if (st.valid) {
      const int g = st.g;
      float req[R], w[R];
      float wsum = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        req[r] = a.group_req[g * R + r];
        w[r] = (req[r] > 0.0f && w_res[r] > 0.0f) ? w_res[r] : 0.0f;
        wsum = (r == 0) ? w[r] : wsum + w[r];
      }
      wsum = fmaxf(wsum, 1e-9f);
      const float bonus_g = a.group_pack_bonus[g];
      const uint8_t* mask_row = a.group_mask + (size_t)g * N;
      const float* static_row = a.group_static + (size_t)g * N;
      for (int i = tid; i < N; i += kThreads) {
        // every load of the node is issued before any branch on what it
        // read, so the loads overlap instead of waiting on one another
        const int maxt = __ldg(a.node_max_tasks + i);
        const int nt = a.ntasks[i];
        const bool in_mask = __ldg(mask_row + i) != 0;
        const float stat = __ldg(static_row + i);
        const float pk = st.same_bucket ? a.pack[i] : 0.0f;
        float idle[R], fut[R], alloc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          idle[r] = a.idle[r * N + i];
          fut[r] = a.future[r * N + i];
          alloc[r] = __ldg(a.node_alloc + r * N + i);
        }
        const bool ok = in_mask & ((maxt == 0) | (nt < maxt));
        bool fi = ok, ff = ok;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          fi &= req[r] <= idle[r] + eps[r];
          ff &= req[r] <= fut[r] + eps[r];
        }
        if (!(fi | ff)) continue;
        // ops/score.py:node_score, operation for operation
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
        s = s + (stat + pk * bonus_g);
        if (fi) better_of(bi_s, bi_i, s, i);
        if (ff) better_of(bf_s, bf_i, s, i);
      }
    }
    warp_argmax(bi_s, bi_i);
    warp_argmax(bf_s, bf_i);
    if (lane == 0) {
      s_ws_idle[warp] = bi_s;
      s_wi_idle[warp] = bi_i;
      s_ws_fut[warp] = bf_s;
      s_wi_fut[warp] = bf_i;
    }
    __syncthreads();

    // ---- warp 0 reduces across warps; thread 0 does the scalar work
    if (warp == 0) {
      bi_s = s_ws_idle[lane];
      bi_i = s_wi_idle[lane];
      bf_s = s_ws_fut[lane];
      bf_i = s_wi_fut[lane];
      warp_argmax(bi_s, bi_i);
      warp_argmax(bf_s, bf_i);
      if (lane == 0) {
        const int g = st.g;
        const bool any_idle = bi_i != kNone;
        int sel = bi_i;
        bool placed_ok = any_idle, pipe = false;
        if (a.allow_pipeline && !any_idle && bf_i != kNone) {
          sel = bf_i;
          placed_ok = true;
          pipe = true;
        }
        if (placed_ok) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float req = a.group_req[g * R + r];
            if (!pipe) a.idle[r * N + sel] = a.idle[r * N + sel] - req;
            a.future[r * N + sel] = a.future[r * N + sel] - req;
            placed_res[r] = placed_res[r] + req;
          }
          a.ntasks[sel] += 1;
          a.pack[sel] = a.pack[sel] + 1.0f;
          pack_count += 1;
          pack_last = sel;
          placed += 1;
          placed_alloc += pipe ? 0 : 1;
          a.assign[st.t_idx] = sel;
          a.pipelined[st.t_idx] = pipe;
        }
        if (st.valid) cur_bucket = a.task_bucket[st.t_idx];
        t_off += 1;

        // ---- job boundary: gang commit/rollback + charges + next job
        int complete = t_off >= a.job_n_tasks[job];
        int roll = 0, fix_start = 0, fix_n = 0;
        if (complete) {
          int base = a.job_ready_base[job], mina = a.job_min_available[job];
          bool is_ready = base + placed_alloc >= mina;
          bool is_kept = base + placed >= mina;
          roll = !(is_ready || is_kept);
          fix_start = a.job_task_start[job];
          fix_n = min(a.job_n_tasks[job], T - fix_start);
          if (!roll) {
            int q = a.pool_queue[pool], ns = a.pool_ns[pool];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              a.q_alloc[q * R + r] = a.q_alloc[q * R + r] + placed_res[r];
              a.ns_alloc[ns * R + r] = a.ns_alloc[ns * R + r] + placed_res[r];
            }
          }
          a.p_cursor[pool] += 1;
          if (is_ready) a.ready[job] = 1;
          if (is_kept) a.kept[job] = 1;
          pool = select_pool<R>(a, eps, &job);
          t_off = placed = placed_alloc = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) placed_res[r] = 0.0f;
        }
        publish(complete, roll, fix_start, fix_n);
      }
    }
    __syncthreads();
  }

  // ---- tasks of jobs neither committed nor kept are not placed
  for (int t = tid; t < T; t += kThreads) {
    int j = min(max(a.task_job[t], 0), a.J - 1);
    if (!(a.task_valid[t] && (a.ready[j] || a.kept[j]))) {
      a.assign[t] = -1;
      a.pipelined[t] = 0;
    }
  }
}

template <int R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  gang_allocate_kernel<R><<<1, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` without synchronising. Returns the
// cudaError_t of the launch (0 on success); 1 (cudaErrorInvalidValue) for
// a resource count outside 2..8.
int gang_allocate_launch(
    const void* task_group, const void* task_valid, const void* task_bucket,
    const void* task_job, const void* group_req, const void* group_mask,
    const void* group_static, const void* group_pack_bonus,
    const void* job_min_available, const void* job_ready_base,
    const void* job_task_start, const void* job_n_tasks,
    const void* pool_queue, const void* pool_ns, const void* pool_job_start,
    const void* pool_njobs, const void* ns_weight, const void* ns_total,
    const void* queue_deserved, const void* node_alloc,
    const void* node_max_tasks, const void* eps, const void* weights,
    void* idle, void* future, void* ntasks, void* ck_idle, void* ck_future,
    void* ck_ntasks, void* pack, void* q_alloc, void* ns_alloc,
    void* p_cursor, void* assign, void* pipelined, void* ready, void* kept,
    int T, int J, int P, int NS, int N, int R, int allow_pipeline,
    int ns_live, void* stream) {
  Args a;
  a.task_group = static_cast<const int32_t*>(task_group);
  a.task_valid = static_cast<const uint8_t*>(task_valid);
  a.task_bucket = static_cast<const int32_t*>(task_bucket);
  a.task_job = static_cast<const int32_t*>(task_job);
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
  a.node_alloc = static_cast<const float*>(node_alloc);
  a.node_max_tasks = static_cast<const int32_t*>(node_max_tasks);
  a.eps = static_cast<const float*>(eps);
  a.weights = static_cast<const float*>(weights);
  a.idle = static_cast<float*>(idle);
  a.future = static_cast<float*>(future);
  a.ntasks = static_cast<int32_t*>(ntasks);
  a.ck_idle = static_cast<float*>(ck_idle);
  a.ck_future = static_cast<float*>(ck_future);
  a.ck_ntasks = static_cast<int32_t*>(ck_ntasks);
  a.pack = static_cast<float*>(pack);
  a.q_alloc = static_cast<float*>(q_alloc);
  a.ns_alloc = static_cast<float*>(ns_alloc);
  a.p_cursor = static_cast<int32_t*>(p_cursor);
  a.assign = static_cast<int32_t*>(assign);
  a.pipelined = static_cast<uint8_t*>(pipelined);
  a.ready = static_cast<uint8_t*>(ready);
  a.kept = static_cast<uint8_t*>(kept);
  a.T = T;
  a.J = J;
  a.P = P;
  a.NS = NS;
  a.N = N;
  a.allow_pipeline = allow_pipeline;
  a.ns_live = ns_live;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    case 8: return launch<8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* gang_allocate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
